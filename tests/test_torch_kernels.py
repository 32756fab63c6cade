"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX Pallas kernels run in interpret mode (and the
JAX oracles in ``kernels/ref.py``) on the same numpy inputs:

* page decode bit-exact over every wire dtype, several record counts that
  are not powers of two, and several fields in one pass;
* paged attention allclose at the JAX kernel tests' f32 tolerances
  (atol 3e-5 / rtol 1e-4, tests/test_kernels.py), including a ``ctx == 0``
  row, which both kernels answer with zeros.

The CUDA cases compare each kernel with its plain version on the card and
skip where there is none (``tests/test_torch_dense.py`` holds the plain
versions of the flash attention and RG-LRU kernels against JAX,
``tests/test_torch_rwkv.py`` that of the WKV scan).
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import bebop_decode as jbd
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref

from repro_torch.kernels import bebop_decode as bd
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw

ATOL, RTOL = 3e-5, 1e-4

#: (offset, count, wire, out) over a 64-byte record: every wire dtype,
#: integer widening/narrowing, and an int32 wire decoded to float32 (the
#: TPU kernel converts the unsigned value of its bytes)
PLAN = ((0, 3, "uint32", "int32"), (12, 2, "int32", "int32"),
        (20, 2, "float32", "float32"), (28, 3, "uint16", "uint16"),
        (34, 2, "bfloat16", "float32"), (38, 2, "float16", "float32"),
        (42, 4, "uint8", "uint8"), (46, 1, "bool", "uint8"),
        (47, 1, "byte", "float32"), (48, 2, "uint32", "uint32"),
        (56, 2, "uint16", "int32"), (60, 1, "int32", "float32"))

#: the JAX oracle's natural output dtype per wire (ref.DECODERS)
REF_OUT = {"uint32": "uint32", "int32": "int32", "float32": "float32",
           "uint16": "uint16", "bfloat16": "float32", "float16": "float32",
           "uint8": "uint8", "byte": "uint8", "bool": "uint8"}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _page(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 64),
                                                dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


# -- page decode ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 100, 300])
def test_decode_columns_plain_matches_pallas(n):
    page = _page(n, n)
    got = bd.decode_columns(torch.from_numpy(page), PLAN)
    want = jops.decode_columns(jnp.asarray(page), PLAN, block_n=n,
                               impl="pallas")
    for f, a, b in zip(PLAN, got, want):
        assert a.numpy().dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b), err_msg=f)


@pytest.mark.parametrize("wire", sorted(REF_OUT))
@pytest.mark.parametrize("n", [5, 257])
def test_decode_column_plain_matches_pallas_and_ref(wire, n):
    page = _page(n, 7 * n)
    width = {"uint32": 4, "int32": 4, "float32": 4, "uint16": 2,
             "bfloat16": 2, "float16": 2}.get(wire, 1)
    off = 8   # aligned for every element size
    count = (64 - off) // width
    got = bd.decode_column(torch.from_numpy(page), offset=off, count=count,
                           wire_dtype=wire).numpy()
    pallas = jbd.decode_column(jnp.asarray(page), offset=off, count=count,
                               wire_dtype=wire, block_n=n, interpret=True)
    oracle = jref.DECODERS[wire](jnp.asarray(page), off, count)
    assert got.dtype == np.dtype(REF_OUT[wire])
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


def test_decode_rejects_bad_plans():
    page = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="overruns"):
        bd.decode_columns(page, [(4, 2, "uint32", "int32")])
    with pytest.raises(ValueError, match="float32"):
        bd.decode_columns(page, [(0, 1, "float32", "int32")])
    with pytest.raises(ValueError, match="wire"):
        bd.decode_columns(page, [(0, 1, "int64", "int32")])


@pytest.mark.parametrize("lead,stride", [(1, 67), (3, 100)])
def test_decode_columns_plain_matches_pallas_on_row_slices(lead, stride):
    """A page that is a row slice of a larger one, at a stride that is not
    a multiple of 16 (the kernel stages such a page with an unaligned head
    and tail): the plain version on the slice equals the Pallas kernel on
    a copy of the same rows."""
    big = np.random.default_rng(stride).integers(0, 256, (lead + 9, stride),
                                                 dtype=np.uint8)
    page = torch.from_numpy(big)[lead:]
    got = bd.decode_columns(page, PLAN)
    want = jops.decode_columns(jnp.asarray(big[lead:]), PLAN, block_n=9,
                               impl="pallas")
    for f, a, b in zip(PLAN, got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b), err_msg=f)


@pytest.mark.parametrize("slot", range(4))
def test_decode_plan_cache_keys_by_whole_fields_tuple(slot):
    """The packed plan is built once per ``fields`` tuple and cached by the
    whole tuple: two plans that differ in one offset, count, wire or out
    code never share an entry."""
    one = ((0, 2, "uint32", "int32"), (8, 4, "uint8", "uint8"))
    field = list(one[0])
    field[slot] = {0: 4, 1: 3, 2: "int32", 3: "uint32"}[slot]
    other = (tuple(field), one[1])
    a, b = bd._plan(one), bd._plan(other)
    assert a is not b and bd._plan(one) is a and bd._plan(other) is b
    assert bd._plan([list(f) for f in other]) is b   # a list keys by value
    packed = [(f.offset, f.count, f.wire, f.out) for f in b.packed.f[:2]]
    assert packed == [(off, cnt, bd.WIRE_CODES[wd], bd.OUT_CODES[od])
                      for off, cnt, wd, od in other]
    page = torch.from_numpy(_page(3, slot))
    for fields in (one, other):
        got = bd.decode_columns(page, fields)
        want = bd.decode_columns_plain(page, [list(f) for f in fields])
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)


# -- paged attention -------------------------------------------------------------

def _paged_setup(rng, b, hq, hkv, d, bs, m, n, t):
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    kp = rng.standard_normal((n, hkv, bs, d)).astype(np.float32)
    vp = rng.standard_normal((n, hkv, bs, d)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, n))[:m]
                       for _ in range(b)]).astype(np.int32)
    return q, kp, vp, tables


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv,d,bs,m,n", [
    (4, 4, 2, 16, 8, 6, 32),
    (2, 8, 1, 64, 16, 4, 16),     # MQA
    (3, 6, 2, 32, 16, 8, 64),     # g = 6, as qwen2-1.5b
])
def test_paged_decode_plain_matches_pallas(b, hq, hkv, d, bs, m, n):
    rng = np.random.default_rng(b * 100 + d)
    q, kp, vp, tables = _paged_setup(rng, b, hq, hkv, d, bs, m, n, 1)
    ctx = rng.integers(1, m * bs + 1, b).astype(np.int32)
    ctx[0] = 0                           # no valid key: zeros in both
    got = pa.paged_attention(*_t(q[:, :, 0], kp, vp, tables, ctx)).numpy()
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q[:, :, 0]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx), interpret=True))
    assert not got[0].any()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [5, 8, 16])
def test_paged_prefill_plain_matches_pallas_mixed_rows(t):
    """Decode rows padded to the tile width beside prefill chunks, and a
    verify-width tile (T = spec_len + 1 = 5)."""
    rng = np.random.default_rng(t)
    b, hq, hkv, d, bs, m, n = 4, 4, 2, 16, 8, 4, 32
    q, kp, vp, tables = _paged_setup(rng, b, hq, hkv, d, bs, m, n, t)
    qpos = np.stack([
        np.full(t, 19),            # decode row, ctx 20, t-1 pad duplicates
        5 + np.arange(t),          # prefill chunk at offset 5
        np.full(t, 0),             # decode row at the very first position
        np.arange(t),              # prefill chunk from position 0
    ]).astype(np.int32)
    got = pa.paged_prefill_attention(*_t(q, kp, vp, tables, qpos)).numpy()
    want = np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(qpos), interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the JAX oracle agrees wherever every row has a valid key
    oracle = np.asarray(jref.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(qpos)))
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [1, 8])
def test_paged_plain_ignores_unlisted_blocks(t):
    """Scribbling over every block not in a row's table changes nothing."""
    rng = np.random.default_rng(3)
    b, hq, hkv, d, bs, m, n = 2, 4, 2, 16, 8, 4, 32
    q, kp, vp, tables = _paged_setup(rng, b, hq, hkv, d, bs, m, n, t)
    qpos = np.stack([3 + np.arange(t), 11 + np.arange(t)]).astype(np.int32)
    out1 = ops.paged_attention(*_t(q, kp, vp, tables, qpos))
    listed = set(tables.reshape(-1).tolist())
    for blk in range(n):
        if blk not in listed:
            kp[blk] = 1e3
            vp[blk] = -1e3
    out2 = ops.paged_attention(*_t(q, kp, vp, tables, qpos))
    assert torch.equal(out1, out2)


def test_ops_dispatch_decode_equals_prefill_and_reference():
    """ops.paged_attention: T == 1 takes the decode wrapper with
    ctx = qpos + 1; it agrees with the prefill form and with the plain
    version called by name (impl="reference")."""
    rng = np.random.default_rng(11)
    q, kp, vp, tables = _paged_setup(rng, 3, 4, 2, 16, 8, 4, 32, 1)
    qpos = np.array([[0], [9], [31]], np.int32)
    args = _t(q, kp, vp, tables, qpos)
    dec = ops.paged_attention(*args)
    pre = pa.paged_prefill_attention(*args)
    ref = ops.paged_attention(*args, impl="reference")
    torch.testing.assert_close(dec, pre, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dec, ref, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(*args, impl="pallas")


def test_launch_count_exact_across_threads():
    """Client threads launch kernels at once; no count may be lost."""
    def wrapper():
        pass
    wrapper.launches = 0

    def hammer():
        for _ in range(2000):
            build.count_launch(wrapper)
    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert wrapper.launches == 8 * 2000


def test_flash_build_refuses_spills_and_keys_its_library_by_its_flags(
        monkeypatch):
    """ptxas turns a spill in flash_attention.cu or paged_attention.cu (the
    bf16 attention bodies) or in the two scans into an error, and the
    library's name hashes
    the flags it was built with, so a library built without that check is
    not reused."""
    for name in ("flash_attention", "paged_attention", "rglru_scan",
                 "rwkv6_scan"):
        flags = build._flags(name)
        assert flags[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
        assert flags[-2:] == ("-Xptxas", "-warn-spills,-Werror")
    assert build._flags("bebop_decode") == build.NVCC_FLAGS
    before = build._target("flash_attention")
    monkeypatch.setattr(build, "SOURCE_FLAGS", {})
    assert build._target("flash_attention") != before


def test_build_keys_each_library_by_the_shared_headers(tmp_path,
                                                       monkeypatch):
    """Every source includes csrc/*.cuh, so an edited header renames (and
    so rebuilds) every library."""
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = sorted(p.stem for p in tmp_path.glob("*.cu"))
    before = {n: build._target(n) for n in names}
    header = tmp_path / "mma_bf16.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert all(build._target(n) != before[n] for n in names)


# -- on the card -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 4097])
def test_cuda_decode_kernel_bit_exact(cuda, n):
    page = torch.from_numpy(_page(n, n)).to(cuda)
    before = bd.decode_columns.launches
    got = bd.decode_columns(page, PLAN)
    assert bd.decode_columns.launches == before + 1
    for f, a, b in zip(PLAN, got, bd.decode_columns_plain(page, PLAN)):
        np.testing.assert_array_equal(_bits(a.cpu().numpy()),
                                      _bits(b.cpu().numpy()), err_msg=f)


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, ATOL, RTOL),
    # bf16 outputs: fp32 sums in another order, then one rounding to bf16
    (torch.bfloat16, 2e-2, 2e-2),
])
@pytest.mark.parametrize("t", [1, 5, 32])
def test_cuda_paged_kernels_match_plain(cuda, dtype, atol, rtol, t):
    rng = np.random.default_rng(t)
    b, hq, hkv, d, bs, m, n = 8, 12, 2, 128, 16, 16, 200
    q, kp, vp, tables = _paged_setup(rng, b, hq, hkv, d, bs, m, n, t)
    ends = rng.integers(t, m * bs, b)
    qpos = (ends[:, None] - t + np.arange(t)).astype(np.int32)
    q, kp, vp, tables, qpos = [x.to(cuda) for x in _t(q, kp, vp, tables,
                                                       qpos)]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = ops.paged_attention(q, kp, vp, tables, qpos)
    want = pa.paged_prefill_attention_plain(q, kp, vp, tables, qpos)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n", [1, 7, 255, 4097])
@pytest.mark.parametrize("stride,lead,shift", [
    (64, 0, 0),
    (67, 0, 0),            # a stride that is not a multiple of 16
    (67, 1, 0),            # a row slice starting 3 bytes off a boundary
    (100, 3, 20),          # 12 bytes off, the plan 20 bytes into the row
])
def test_cuda_decode_kernel_bit_exact_on_unaligned_pages(cuda, n, stride,
                                                          lead, shift):
    big = np.random.default_rng(n + stride).integers(
        0, 256, (n + lead, stride), dtype=np.uint8)
    page = torch.from_numpy(big).to(cuda)[lead:]
    plan = [(off + shift, cnt, wd, od) for off, cnt, wd, od in PLAN]
    before = bd.decode_columns.launches
    got = bd.decode_columns(page, plan)
    assert bd.decode_columns.launches == before + 1
    for f, a, b in zip(plan, got, bd.decode_columns_plain(page, plan)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a.cpu().numpy()),
                                      _bits(b.cpu().numpy()), err_msg=f)


@pytest.mark.parametrize("wire,out", [
    ("uint32", "int32"), ("int32", "uint32"), ("float32", "float32"),
    ("uint16", "uint16"), ("uint8", "uint8"),
    ("uint16", "int32"),    # widens: staged, not copied
])
@pytest.mark.parametrize("n,lead", [(1, 0), (7, 0), (4097, 0), (7, 1)])
def test_cuda_decode_kernel_bit_exact_on_whole_row_columns(cuda, wire, out,
                                                           n, lead):
    """A one-field plan whose output is the page's own bytes is copied
    (16-byte aligned pages: lead 0); a row slice off a 16-byte boundary
    (lead 1 row of 100 bytes) takes the staged path."""
    stride = 64 if lead == 0 else 100
    big = np.random.default_rng(n + lead).integers(
        0, 256, (n + lead, stride), dtype=np.uint8)
    page = torch.from_numpy(big).to(cuda)[lead:]
    width = {"uint32": 4, "int32": 4, "float32": 4, "uint16": 2}.get(wire, 1)
    kw = dict(offset=0, count=stride // width, wire_dtype=wire, out_dtype=out)
    before = bd.decode_column.launches
    got = bd.decode_column(page, **kw)
    assert bd.decode_column.launches == before + 1
    want = bd.decode_columns_plain(page, [tuple(kw.values())])[0]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(want.cpu().numpy()))


@pytest.mark.parametrize("n", [1, 3])
def test_cuda_decode_kernel_bit_exact_on_rows_read_in_place(cuda, n):
    """Rows too wide to stage in shared memory are decoded in place."""
    stride = 50_000
    page = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (n, stride), dtype=np.uint8)).to(cuda)
    plan = [(off + stride - 64, cnt, wd, od) for off, cnt, wd, od in PLAN]
    plan.append((0, stride // 4, "uint32", "uint32"))   # one wide column
    for f, a, b in zip(plan, bd.decode_columns(page, plan),
                       bd.decode_columns_plain(page, plan)):
        np.testing.assert_array_equal(_bits(a.cpu().numpy()),
                                      _bits(b.cpu().numpy()), err_msg=f)


def _edge_qpos(b, t, keys):
    """Query positions of b rows ending at the bf16 body's tile edges (63,
    64, 65, 129 keys), past 1,024 keys, at the table's end, and two decode
    rows: ctx == 0 (no valid key) and one padded to the tile width."""
    ends = np.minimum([0, 63, 64, 65, 129, 2000, 40, keys], keys)[:b]
    qpos = ends[:, None] - t + np.arange(t)[None]
    qpos[0] = -1                       # no valid key: zeros
    qpos[6] = 39                       # a decode row padded to width t
    return qpos.astype(np.int32)


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, ATOL, RTOL),
    (torch.bfloat16, 2e-2, 2e-2),
])
@pytest.mark.parametrize("t", [1, 5, 32])
@pytest.mark.parametrize("bs,m", [
    (8, 37),       # 37 blocks: not a multiple of the 8 a 64-key tile takes
    (16, 130),     # 2,080 keys: contexts past 1,024
    (32, 5),
    (64, 3),       # a 64-key tile is one block
])
def test_cuda_paged_kernels_at_tile_edges(cuda, dtype, atol, rtol, t, bs, m):
    rng = np.random.default_rng(bs * t + m)
    b, hq, hkv, d = 8, 12, 2, 128
    n = b * m + 1
    q, kp, vp, tables = _paged_setup(rng, b, hq, hkv, d, bs, m, n, t)
    tables[1, -1] = n + 5                 # out of range: clamped
    qpos = _edge_qpos(b, t, m * bs)
    q, kp, vp, tables, qpos = [x.to(cuda) for x in _t(q, kp, vp, tables,
                                                       qpos)]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    wrapper = pa.paged_attention if t == 1 else pa.paged_prefill_attention
    before = wrapper.launches
    got = ops.paged_attention(q, kp, vp, tables, qpos)
    assert wrapper.launches == before + 1
    want = pa.paged_prefill_attention_plain(q, kp, vp, tables, qpos)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[0].any()
    # blocks no table lists never reach the output
    listed = torch.zeros(n, dtype=torch.bool, device=cuda)
    listed[tables.long().clamp(0, n - 1).reshape(-1)] = True
    kp[~listed] = 1e3
    vp[~listed] = -1e3
    assert torch.equal(ops.paged_attention(q, kp, vp, tables, qpos), got)


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, ATOL, RTOL),
    (torch.bfloat16, 2e-2, 2e-2),
])
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 256), (4, 2, 64)])
@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("bs,m", [(16, 20), (64, 5)])
def test_cuda_paged_kernels_at_other_head_dims(cuda, dtype, atol, rtol, hq,
                                               hkv, d, t, bs, m):
    """gemma-2b's shape (head_dim 256, MQA; its 32-key bf16 tiles are half
    a 64-key block) and a head_dim-64 one."""
    _paged_against_plain(cuda, dtype, atol, rtol, hq, hkv, d, t, bs, m)


def _paged_against_plain(cuda, dtype, atol, rtol, hq, hkv, d, t, bs, m):
    rng = np.random.default_rng(d + t + bs)
    b = 8
    n = b * m + 1
    q, kp, vp, tables = _paged_setup(rng, b, hq, hkv, d, bs, m, n, t)
    qpos = _edge_qpos(b, t, m * bs)
    q, kp, vp, tables, qpos = [x.to(cuda) for x in _t(q, kp, vp, tables,
                                                       qpos)]
    q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
    got = ops.paged_attention(q, kp, vp, tables, qpos)
    want = pa.paged_prefill_attention_plain(q, kp, vp, tables, qpos)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("d", [40, 96, 100, 512])
@pytest.mark.parametrize("t", [1, 32])
def test_cuda_paged_f32_kernel_at_head_dims_bf16_lacks(cuda, d, t):
    """float32 takes any head_dim that is a multiple of 4 up to 512: 40, 96
    and 100 run in a wider body with zero-filled columns."""
    _paged_against_plain(cuda, torch.float32, ATOL, RTOL, 4, 2, d, t, 8, 9)


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 96),      # not one of the bf16 body's widths
    (torch.bfloat16, 512),
    (torch.float32, 98),       # not a multiple of 4
    (torch.float32, 516),      # wider than 512
])
def test_cuda_paged_kernel_refuses_head_dims_it_lacks(cuda, dtype, d):
    rng = np.random.default_rng(0)
    q, kp, vp, tables = _paged_setup(rng, 2, 4, 2, d, 16, 4, 9, 5)
    qpos = np.stack([np.arange(5), 10 + np.arange(5)]).astype(np.int32)
    args = [x.to(cuda) for x in _t(q, kp, vp, tables, qpos)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    shape = rf"head_dim 64, 128 or 256 in bfloat16.*{d}\)"
    with pytest.raises(ValueError, match=shape):
        pa.paged_prefill_attention(*args)
    with pytest.raises(ValueError, match=shape):
        pa.paged_attention(args[0][:, :, 0], *args[1:4], args[4][:, 0] + 1)


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, ATOL, RTOL),
    (torch.bfloat16, 2e-2, 2e-2),
])
@pytest.mark.parametrize("hq,hkv,d,tq,s,causal,window,q_offset", [
    (12, 2, 128, 97, 97, True, None, 0),      # qwen2-1.5b, ragged prefill
    (12, 2, 128, 33, 150, True, None, 117),   # offset queries
    (12, 2, 128, 40, 70, False, None, 0),     # non-causal
    (16, 1, 256, 300, 300, True, 64, 0),      # recurrentgemma, window
    (16, 1, 256, 4, 10, True, 8, 14),         # rows with no valid key
    # the bf16 body's tile edges: 64 folded rows a CTA, 64-key (D 128) and
    # 32-key (D 256) K/V tiles
    (12, 2, 128, 63, 63, True, None, 0),
    (12, 2, 128, 64, 64, True, None, 0),
    (12, 2, 128, 65, 65, True, None, 0),
    (12, 2, 128, 129, 129, True, None, 0),
    (16, 1, 256, 63, 63, True, None, 0),
    (16, 1, 256, 65, 65, True, None, 0),
    (16, 1, 256, 129, 129, True, None, 0),
    (12, 2, 128, 65, 129, True, None, 37),    # offset off the tile grid
    (16, 1, 256, 63, 129, True, None, 37),
    (16, 1, 256, 300, 300, True, 8, 0),       # window narrower than a tile
    (16, 1, 256, 2000, 2000, True, 2048, 0),  # recurrentgemma full width
])
def test_cuda_flash_kernel_matches_plain(cuda, dtype, atol, rtol, hq, hkv, d,
                                         tq, s, causal, window, q_offset):
    rng = np.random.default_rng(tq + s)
    q = rng.standard_normal((2, hq, tq, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, s, d)).astype(np.float32)
    q, k, v = [x.to(cuda).to(dtype) for x in _t(q, k, v)]
    before = fa.flash_attention.launches
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    empty = (torch.arange(tq) + q_offset - (s - 1)) >= (window or s + tq)
    assert not got[:, :, empty.to(cuda)].any()


# the kernel rounds the multiply and the add apart, as the plain loop does:
# float32 h and h_final are bit-equal; bf16 h within one bf16 rounding
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d", [
    (2, 300, 4096), (1, 1, 4096), (1, 2000, 4096),
    (3, 17, 100), (3, 300, 100),   # a ragged last slab
    (2, 65, 37),                   # rows off 16 bytes: the staged loads
])
def test_cuda_rglru_kernel_matches_plain(cuda, dtype, b, t, d):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    a = rng.random((b, t, d)).astype(np.float32)
    x, a = [y.to(cuda).to(dtype) for y in _t(x, a)]
    before = rg.rglru_scan.launches
    h, hf = rg.rglru_scan(x, a)
    assert rg.rglru_scan.launches == before + 1
    h2, hf2 = rg.rglru_scan_plain(x, a)
    assert h.dtype == dtype and hf.dtype == torch.float32
    if dtype == torch.float32:
        assert torch.equal(h, h2)
        assert torch.equal(hf, hf2)
    else:
        torch.testing.assert_close(h.float(), h2.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(hf, hf2, atol=2e-2, rtol=2e-2)


def test_cuda_rglru_kernel_on_a_base_off_16_bytes(cuda):
    """x and a that start 4 bytes past an allocation's start take the
    kernel's staged loads, not cp.async, and stay bit-exact."""
    rng = np.random.default_rng(5)
    n = 2 * 70 * 64
    x, a = _t(rng.standard_normal(n + 1).astype(np.float32),
              rng.random(n + 1).astype(np.float32))
    x, a = [y.to(cuda)[1:].view(2, 70, 64) for y in (x, a)]
    h, hf = rg.rglru_scan(x, a)
    h2, hf2 = rg.rglru_scan_plain(x, a)
    assert torch.equal(h, h2) and torch.equal(hf, hf2)


# every product and sum is rounded as the plain loop rounds it, and o's
# K-sum runs in its pairwise tree: o and the state bit-exact in both dtypes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,kk,vv,w0", [
    (1, 1, 32, 16, 16, None), (2, 2, 64, 32, 32, None),
    (1, 4, 128, 64, 64, None),
    (2, 64, 7, 64, 64, -6.0),     # rwkv6-7b's heads, ragged T, the init decay
    (1, 64, 400, 64, 64, -6.0),
    (1, 64, 2000, 64, 64, -6.0),
    (3, 8, 1, 64, 64, None),
    (3, 64, 130, 64, 64, -6.0),   # three rows: several CTAs a head
    (2, 4, 45, 64, 16, None),     # V 16: one 16-wide block of channels
    (2, 3, 33, 16, 32, None),
    (1, 2, 70, 32, 64, None),
])
def test_cuda_rwkv6_kernel_matches_plain(cuda, dtype, b, h, t, kk, vv, w0):
    """Decays ``exp(-exp(N(0, 1)))`` as in the JAX kernel tests, or near
    the model's init ``w0 = -6`` (w ~ 0.9975), where the state grows over
    T.  r, k, v, w reach the kernel as [B, H, T, K] views of [B, T, H, K]
    tensors, as the model passes them."""
    rng = np.random.default_rng(t + kk + vv)
    r, k = (rng.standard_normal((b, t, h, kk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, h, vv)).astype(np.float32)
    logw = rng.standard_normal((b, t, h, kk)) * (0.5 if w0 else 1.0)
    w = np.exp(-np.exp(logw + (w0 or 0.0))).astype(np.float32)
    u = (rng.standard_normal((h, kk)) * 0.3).astype(np.float32)
    r, k, v = (x.to(cuda).to(dtype).transpose(1, 2) for x in _t(r, k, v))
    w = _t(w)[0].to(cuda).transpose(1, 2)
    u = _t(u)[0].to(cuda)
    before = rw.rwkv6_scan.launches
    o, s = rw.rwkv6_scan(r, k, v, w, u)
    assert rw.rwkv6_scan.launches == before + 1
    o2, s2 = rw.rwkv6_scan_plain(r, k, v, w, u)
    assert o.dtype == dtype and s.dtype == torch.float32
    assert torch.equal(s, s2)
    assert torch.equal(o, o2)


def test_cuda_rwkv6_kernel_refuses_rows_off_16_bytes(cuda):
    """The kernel copies rows by 16-byte cp.async: a row that starts off a
    16-byte boundary raises, naming the tensor, and launches nothing."""
    b, h, t, kk = 1, 2, 5, 16
    flat = torch.randn(b * h * t * kk + 1, device=cuda)
    r = flat[1:].view(b, h, t, kk)
    k, v, w = (torch.randn(b, h, t, kk, device=cuda) for _ in range(3))
    u = torch.randn(h, kk, device=cuda)
    before = rw.rwkv6_scan.launches
    with pytest.raises(ValueError, match="rows of r .*16-byte"):
        rw.rwkv6_scan(r, k, v, w.sigmoid(), u)
    assert rw.rwkv6_scan.launches == before

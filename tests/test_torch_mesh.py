"""The port's multi-device tooling against the JAX package's, on the CPU.

* Specs: for every arch on the (16, 16) and (2, 16, 16) production
  meshes, ``param_specs`` (tp, fsdp, tp with expert parallelism),
  ``zero_specs``, ``opt_state_specs``, ``batch_specs`` (every shape and
  mode) and ``cache_specs`` (decode shapes) equal JAX's leaf for leaf by
  path.  The spec functions read only the mesh's axis names and shape, so
  both packages get a stand-in mesh and no process group is needed.
* Cells: ``arch_shape_cells``, ``input_specs`` (shapes and dtypes),
  ``effective_config`` and ``model_flops_for`` equal JAX's.
* Roofline: the three terms with the H100 constants.
* The op counter: matmul FLOPs in loops (the counterpart of the HLO
  analyzer's scan tests), no collectives on one rank, and on a fake
  (2, 2) group one all-gather of a column-parallel product, bytes by hand.
* ``named`` placements, and the mesh helpers on a stand-in mesh.
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

import jax
from jax.sharding import PartitionSpec as JP
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import cells as JC
from repro.launch import roofline as JR
from repro.launch import shardings as JS
from repro.models import get_model as jax_get_model

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import cells as C
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R
from repro_torch.launch import shardings as S
from repro_torch.models import get_model
from repro_torch.train import optimizer as O
from repro_torch.utils.op_count import OpCounter

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
TORCH_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
                "float32": torch.float32}


def _jax_mesh(kind):
    shape, axes = MESHES[kind]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _port_mesh(kind):
    shape, axes = MESHES[kind]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {JS._path_names(p): tuple(s) for p, s in flat}


def _port_flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (k,)))
        return out
    return {path: tuple(tree)}


def _same(jax_tree, port_tree):
    j, p = _jax_flat(jax_tree), _port_flat(port_tree)
    assert j.keys() == p.keys()
    diff = {k: (j[k], p[k]) for k in j if j[k] != p[k]}
    assert not diff, diff


@pytest.fixture(scope="module")
def abstract():
    """Abstract params and decode caches of every arch, both packages."""
    out = {}
    for arch in ARCH_IDS:
        jm = jax_get_model(jax_get_config(arch))
        pm = get_model(get_config(arch))
        with FakeTensorMode():
            p_params = pm.init(0, torch.device("cpu"))
            p_cache = {s.name: pm.init_cache(s.global_batch, s.seq_len,
                                             torch.device("cpu"))
                       for s in SHAPES.values() if s.kind == "decode"}
        j_params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        j_cache = {s.name: jax.eval_shape(
            lambda s=s: jm.init_cache(s.global_batch, s.seq_len))
            for s in JSHAPES.values() if s.kind == "decode"}
        out[arch] = (j_params, p_params, j_cache, p_cache)
    return out


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_jax(abstract, arch, kind):
    j_params, p_params, _, _ = abstract[arch]
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jm, pm = _jax_mesh(kind), _port_mesh(kind)
    for kw in (dict(mode="tp"), dict(mode="fsdp"),
               dict(mode="tp", expert_parallel=True)):
        js = JS.param_specs(jcfg, j_params, jm, **kw)
        ps = S.param_specs(cfg, p_params, pm, **kw)
        _same(js, ps)
        _same(JS.zero_specs(js, j_params, jm),
              S.zero_specs(ps, p_params, pm))
        for zero in (True, False):
            _same(JS.opt_state_specs(jcfg, js, j_params, jm, zero=zero),
                  S.opt_state_specs(cfg, ps, p_params, pm, zero=zero))
    # train/optimizer.py's ZeRO-1 specs, on the data axis
    js = JS.param_specs(jcfg, j_params, jm)
    ps = S.param_specs(cfg, p_params, pm)
    from repro.train.optimizer import zero_specs as jax_zero
    _same(jax_zero(js, j_params, data_size=16),
          O.zero_specs(ps, p_params, data_size=16))


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_jax(abstract, arch, kind):
    _, _, j_cache, p_cache = abstract[arch]
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jm, pm = _jax_mesh(kind), _port_mesh(kind)
    for name in SHAPES:
        for mode in ("tp", "fsdp"):
            _same(JS.batch_specs(jcfg, JSHAPES[name], jm, mode=mode),
                  S.batch_specs(cfg, SHAPES[name], pm, mode=mode))
    for name in j_cache:
        _same(JS.cache_specs(jcfg, j_cache[name], jm),
              S.cache_specs(cfg, p_cache[name], pm))


def test_cells_equal_jax():
    cells = C.arch_shape_cells()
    assert cells == JC.arch_shape_cells()
    assert len(cells) == 40
    assert sum(1 for c in cells if c[2]) == 8
    for arch, shape, _ in cells:
        assert R.model_flops_for(arch, shape) \
            == JR.model_flops_for(arch, shape)
        for ov in (C.CellOverrides(), C.CellOverrides(
                remat="none", sharding="fsdp", rwkv_impl="chunked")):
            jov = JC.CellOverrides(**dataclasses.asdict(ov))
            got = dataclasses.asdict(C.effective_config(arch, shape, ov))
            want = dataclasses.asdict(JC.effective_config(arch, shape, jov))
            assert got.pop("attention_impl") == "reference"
            want.pop("attention_impl")
            assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name in SHAPES:
        got = C.input_specs(cfg, SHAPES[name])
        want = JC.input_specs(jcfg, JSHAPES[name])
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape
            assert got[k].dtype == TORCH_DTYPES[str(v.dtype)]
            assert got[k].device.type == "cpu"


def test_roofline_terms_math():
    rec = {"flops_per_device": R.PEAK_FLOPS, "bytes_per_device": R.HBM_BW,
           "collective_bytes": {"total": R.LINK_BW},
           "score_bytes_per_device": 0.0}
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989.4e12, 3.35e12, 50e9)
    t = R.roofline_terms(rec, model_flops=R.PEAK_FLOPS * 256, chips=256)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 1.0) < 1e-9
    assert abs(t["collective_s"] - 1.0) < 1e-9
    assert abs(t["useful_ratio"] - 1.0) < 1e-9
    assert t["step_time_lower_bound_s"] == pytest.approx(1.0)


def test_counter_matmul_loop():
    x = torch.randn(64, 128)
    ws = torch.randn(6, 128, 128)
    with OpCounter() as c:
        for w in ws:
            x = torch.tanh(x @ w)
    assert c.flops == 6 * 2 * 64 * 128 * 128
    assert c.summary()["collective_bytes"]["total"] == 0.0


def test_counter_nested_loops():
    x = torch.randn(32, 64)
    ws = torch.randn(4, 64, 64)
    with OpCounter() as c:
        for w in ws:
            for _ in range(3):
                x = torch.tanh(x @ w)
    assert c.flops == 4 * 3 * 2 * 32 * 64 * 64
    # each product reads x and w and writes x; tanh reads and writes x
    per = (32 * 64 + 64 * 64 + 32 * 64) * 4 + 2 * 32 * 64 * 4
    assert c.bytes_hbm == 12 * per


@pytest.fixture
def fake_group_4():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_counter_counts_one_all_gather_per_device(fake_group_4):
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 16), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(16, 16), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with OpCounter() as c:
            y = x @ w                                   # [8, 32] (S0, S1)
            z = y.redistribute(mesh, [Shard(0), Replicate()])
    assert tuple(y.to_local().shape) == (4, 16)
    assert tuple(z.to_local().shape) == (4, 32)
    s = c.summary()
    assert s["collective_counts"]["all-gather"] == 1
    assert sum(s["collective_counts"].values()) == 1
    # the gathered [4, 32] float32 result on each rank
    assert s["collective_bytes"]["all-gather"] == 4 * 32 * 4
    # the local product only: 2 * 4 * 16 * 16, not the global 8 x 32
    assert c.flops == 2 * 4 * 16 * 16


def test_named_placements():
    mesh = _port_mesh("multi")
    P = S.PartitionSpec
    assert S.placements(mesh, P(("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert S.placements(mesh, P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.placements(mesh, P(("data", "pod")))
    assert S.local_shape((256, 4096, 1536), mesh,
                         (Shard(0), Shard(0), Shard(2))) == (8, 4096, 96)
    named = S.named(mesh, {"a": P("model"), "b": {"c": P()}})
    assert named["a"].placements == (Replicate(), Replicate(), Shard(0))
    assert named["b"]["c"].mesh is mesh


def test_mesh_helpers_and_production_mesh_needs_ranks():
    mesh = _port_mesh("multi")
    jm = _jax_mesh("multi")
    from repro.launch import mesh as JM
    assert M.dp_axes(mesh) == JM.dp_axes(jm) == ("pod", "data")
    assert M.dp_size(mesh) == JM.dp_size(jm) == 32
    assert M.axis_size(mesh, "model") == 16
    assert M.axis_size(_port_mesh("single"), "pod") == 1
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="dryrun"):
            M.make_production_mesh()


def test_make_host_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_host_mesh()

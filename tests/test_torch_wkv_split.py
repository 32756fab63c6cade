"""The order of operations of the CUDA WKV kernel, held to the plain
version's bits.

The plain version (``rwkv6_scan_plain``) sums o over K as a pairwise tree:
row j plus row j + n/2, halving n.  The CUDA kernel
(``repro_torch/kernels/csrc/rwkv6_scan.cu``) splits V over CTAs in blocks
of 32 channels (16 where V is 16) and K over G warps by residue (G = 8):
warp q holds state rows j = q, q + G, ..., updates them, and reduces its
K/G products as a local pairwise tree (i plus i + K/2G, halving); the CTA
then sums the G partials as the same tree, for G = 4
``(p0 + p2) + (p1 + p3)``.  While n/2 >= G a level of the plain tree only
pairs rows of one residue mod G, so for K in {16, 32, 64} the two orders
are the same sums in the same order.  These tests emulate the kernel's
order in torch on the CPU, for G = 4 and the kernel's 8, and assert
``torch.equal`` with the plain version's o and final state, in float32
and bfloat16, with the JAX kernel tests' decays and the model's; they
also hold the emulation against the JAX package's ``ref.rwkv6`` at the
JAX kernel tests' float32 tolerances, and show that another order of the
partials is not bit-equal.

They check the design's arithmetic, not the CUDA kernel: the kernel is
held to the plain version by the card-only
``test_cuda_rwkv6_kernel_matches_plain`` and by ``chip_smoke.py``'s
``rwkv_kernel`` phase.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref

from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain

ATOL, RTOL = 3e-5, 1e-4
GROUPS = 8    # the kernel's warps a CTA, one per residue of k mod 8
BLOCK = 32    # value channels of a CTA


def _pairwise(x):
    """Sum over dim -2 as a pairwise tree, i plus i + n/2, halving n (n a
    power of two); each add is its own rounded op."""
    while x.shape[-2] > 1:
        half = x.shape[-2] // 2
        x = x[..., :half, :] + x[..., half:, :]
    return x[..., 0, :]


def _combine(p):
    """The kernel's last levels: the same tree over the G partials, for
    G = 4 (p0 + p2) + (p1 + p3)."""
    return _pairwise(torch.stack(p, dim=-2))


def _emulate(r, k, v, w, u, groups=GROUPS, combine=_combine):
    """The kernel's order of operations for r, k, w [B, H, T, K], v [B, H,
    T, V], u [H, K]: each block of value channels on its own, each residue
    q of k mod ``groups`` with its own state rows and local tree.  Returns
    o in float32 (before the cast to v's dtype) and the final state."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    block = min(vv, BLOCK)
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    o = torch.empty((b, h, t, vv))
    state = torch.empty((b, h, kk, vv))
    for v0 in range(0, vv, block):
        cols = slice(v0, v0 + block)
        rows = [slice(q, kk, groups) for q in range(groups)]
        s = [torch.zeros((b, h, kk // groups, block)) for _ in rows]
        u_q = [u[None, :, j, None] for j in rows]
        for i in range(t):
            v_t = v[:, :, i, None, cols]
            p = []
            for q, j in enumerate(rows):
                r_t, k_t = r[:, :, i, j, None], k[:, :, i, j, None]
                kv = k_t * v_t
                p.append(_pairwise(r_t * (s[q] + u_q[q] * kv)))
                s[q] = w[:, :, i, j, None] * s[q] + kv
            o[:, :, i, cols] = combine(p)
        for q, j in enumerate(rows):
            state[:, :, j, cols] = s[q]
    return o, state


def _inputs(seed, b, h, t, kk, vv, decay, dtype):
    """r, k, v ~ N(0, 0.5^2) in ``dtype``, u ~ N(0, 0.3^2) (the JAX kernel
    tests'); decays ``exp(-exp(N(0, 1)))`` ("jax") or the model's init,
    w0 = -6 plus N(0, 0.01^2), w ~ 0.9975 ("model")."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, h, t, kk)) * 0.5 for _ in range(2))
    v = rng.standard_normal((b, h, t, vv)) * 0.5
    logw = rng.standard_normal((b, h, t, kk))
    logw = logw * 0.01 - 6.0 if decay == "model" else logw
    w = np.exp(-np.exp(logw))
    u = rng.standard_normal((h, kk)) * 0.3
    r, k, v = (torch.from_numpy(x.astype(np.float32)).to(dtype)
               for x in (r, k, v))
    w, u = (torch.from_numpy(x.astype(np.float32)) for x in (w, u))
    return r, k, v, w, u


CASES = [(kk, t, decay) for kk in (16, 32, 64) for t in (1, 7, 128)
         for decay in ("jax", "model")]


@pytest.mark.parametrize("groups", [4, GROUPS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kk,t,decay", CASES)
def test_split_order_is_the_plain_versions_bits(kk, t, decay, dtype, groups):
    r, k, v, w, u = _inputs(kk + t, 2, 2, t, kk, kk, decay, dtype)
    o, s = _emulate(r, k, v, w, u, groups)
    o_plain, s_plain = rwkv6_scan_plain(r, k, v, w, u)
    assert torch.equal(s, s_plain)
    assert torch.equal(o.to(dtype), o_plain)


@pytest.mark.parametrize("kk,vv", [(64, 16), (16, 64), (32, 64)])
def test_split_order_is_the_plain_versions_bits_for_k_other_than_v(kk, vv):
    """V 16 (one 16-wide block) and V 64 (two blocks) beside another K."""
    r, k, v, w, u = _inputs(kk * vv, 3, 2, 40, kk, vv, "jax", torch.float32)
    o, s = _emulate(r, k, v, w, u)
    o_plain, s_plain = rwkv6_scan_plain(r, k, v, w, u)
    assert torch.equal(s, s_plain)
    assert torch.equal(o, o_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kk,t,decay", [(16, 7, "jax"), (32, 128, "model"),
                                        (64, 128, "jax"), (64, 128, "model")])
def test_split_order_matches_jax_ref(kk, t, decay, dtype):
    """The emulated float32 o and state against ``ref.rwkv6`` (an einsum
    over K) fed the same float32 values."""
    r, k, v, w, u = _inputs(kk * t, 2, 2, t, kk, kk, decay, dtype)
    o, s = _emulate(r, k, v, w, u)
    jo, js = jref.rwkv6(*(jnp.asarray(x.float().numpy())
                          for x in (r, k, v, w, u)))
    torch.testing.assert_close(o, torch.from_numpy(np.array(jo)),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(s, torch.from_numpy(np.array(js)),
                               atol=ATOL, rtol=RTOL)


def _neighbours(p):
    """Neighbouring partials first: ((p0 + p1) + (p2 + p3)) + ..."""
    while len(p) > 1:
        p = [p[i] + p[i + 1] for i in range(0, len(p), 2)]
    return p[0]


def test_another_order_of_the_partials_is_not_bit_exact():
    """Summing neighbouring partials first, the order a reduction over
    adjacent warps would take, differs from the plain version's o in some
    element: the equality above is a property of the kernel's order, not
    of any."""
    r, k, v, w, u = _inputs(7, 2, 2, 128, 64, 64, "model", torch.float32)
    o, _ = _emulate(r, k, v, w, u, combine=_neighbours)
    o_plain, _ = rwkv6_scan_plain(r, k, v, w, u)
    assert not torch.equal(o, o_plain)
    torch.testing.assert_close(o, o_plain, atol=ATOL, rtol=RTOL)

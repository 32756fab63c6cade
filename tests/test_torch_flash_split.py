"""The precision argument of the bf16 flash-attention kernel's P V step.

The TPU kernel (``src/repro/kernels/flash_attention.py``, ``_attn_kernel``)
forms the probabilities ``p`` in f32 and accumulates ``p·v`` in f32.  The
CUDA kernel (``repro_torch/kernels/csrc/flash_attention.cu``) feeds P to
bf16 tensor cores: it splits P in f32 into ``hi = bf16(P)`` and
``lo = bf16(P - hi)`` and accumulates ``hi·V + lo·V`` in f32.  These tests
emulate the kernel's online softmax in torch on the CPU, tile by tile at
its K/V tile size, for one CTA's 64 folded query rows at both full-width
head groups, and hold the result against the plain version's f32 output
(``flash_attention_plain``) at the JAX kernel tests' f32 tolerances: the
split stays within them, one bf16 P does not.

They check the design's arithmetic, not the CUDA kernel: the kernel itself
is held by the card-only ``test_cuda_flash_kernel_matches_plain`` and by
``chip_smoke.py``'s ``flash_kernel`` phase, whose share of bf16 outputs
that differ from the plain version's is the measure of this split on the
card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain

ATOL, RTOL = 3e-5, 1e-4
ROWS = 64    # folded query rows of one CTA

#: (Hq, Hkv, D, T, window, keys a K/V tile): qwen2-1.5b's 400-token and
#: recurrentgemma-9b's 2,000-token prefill, causal
HEADS = [(12, 2, 128, 400, None, 64), (16, 1, 256, 2000, 2048, 32)]


def _pv_f32(p, v):
    return p @ v


def _pv_split(p, v):
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    return hi @ v + lo @ v


def _pv_single(p, v):
    return p.bfloat16().float() @ v


def _emulate(q, k, v, qpos, *, window, keys, pv):
    """The kernel's online softmax over key tiles for rows ``q`` [R, D] at
    positions ``qpos`` [R] against ``k``, ``v`` [S, D]: scores and
    statistics in f32, ``acc += pv(p, v_tile)``, ``out = acc / l``."""
    s_len, d = k.shape
    kpos = torch.arange(s_len)
    valid = kpos[None, :] <= qpos[:, None]
    if window is not None:
        valid &= (qpos[:, None] - kpos[None, :]) < window
    scores = torch.where(valid, (q @ k.T) * d ** -0.5, float("-inf"))
    m = torch.full((q.shape[0],), float("-inf"))
    l = torch.zeros(q.shape[0])
    acc = torch.zeros_like(q)
    for k0 in range(0, s_len, keys):
        s = scores[:, k0:k0 + keys]
        m_new = torch.maximum(m, s.max(dim=1).values)
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(s - m_use[:, None])
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + pv(p, v[k0:k0 + keys])
        m = m_new
    return acc / torch.where(l == 0, 1.0, l)[:, None]


def _case(hq, hkv, d, t, window, keys, tile, pv):
    """Emulated kernel rows and the plain version's f32 rows for one CTA
    (``tile`` of ``first``/``middle``/``last``) of KV head 0."""
    rng = np.random.default_rng(hq * t + d)
    bf = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .bfloat16().float()
          for shape in ((1, hq, t, d), (1, hkv, t, d), (1, hkv, t, d))]
    q, k, v = bf
    g = hq // hkv
    n_tiles = (g * t + ROWS - 1) // ROWS
    row0 = {"first": 0, "middle": n_tiles // 2, "last": n_tiles - 1}[tile]
    rows = torch.arange(row0 * ROWS, min((row0 + 1) * ROWS, g * t))
    tok, head = rows // g, rows % g          # the kernel's time-major fold
    got = _emulate(q[0, head, tok], k[0, 0], v[0, 0], tok, window=window,
                   keys=keys, pv=pv)
    t0, t1 = int(tok[0]), int(tok[-1]) + 1
    want = flash_attention_plain(q[:, :, t0:t1], k, v, window=window,
                                 q_offset=t0)[0, head, tok - t0]
    return got, want


@pytest.mark.parametrize("tile", ["first", "middle", "last"])
@pytest.mark.parametrize("hq,hkv,d,t,window,keys", HEADS)
def test_split_p_keeps_the_f32_pv(hq, hkv, d, t, window, keys, tile):
    got, want = _case(hq, hkv, d, t, window, keys, tile, _pv_split)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    # and the emulation itself is the f32 function
    f32, _ = _case(hq, hkv, d, t, window, keys, tile, _pv_f32)
    torch.testing.assert_close(f32, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tile", ["first", "middle", "last"])
@pytest.mark.parametrize("hq,hkv,d,t,window,keys", HEADS)
def test_single_bf16_p_leaves_the_f32_tolerance(hq, hkv, d, t, window, keys,
                                                tile):
    got, want = _case(hq, hkv, d, t, window, keys, tile, _pv_single)
    with pytest.raises(AssertionError, match="Tensor-likes are not close"):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)

"""RWKV6 (Finch) WKV recurrence: linear attention with a data-dependent
decay.  Per head, over a ``[K, V]`` float32 state S that starts at zero:

    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

r, k, w are ``[B, H, T, K]``, v ``[B, H, T, V]``, u ``[H, K]``; w holds
the per-step decays in (0, 1] (already ``exp(-exp(.))``).  The result is
``(o [B, H, T, V]`` in the dtype of v, ``S_T [B, H, K, V]`` float32).
:func:`rwkv6_scan` launches ``csrc/rwkv6_scan.cu`` for CUDA tensors and
runs :func:`rwkv6_scan_plain` for CPU tensors.  The kernel takes any T
(the TPU kernel needs a multiple of its chunk), and reads r, k, v and w
by their batch, head and time strides, so the model's ``[B, T, H, K]``
projections reach it as transposed views, uncopied.  It splits V over
CTAs and K over eight warps by residue mod 8, and sums o over K in the
plain version's pairwise tree (``tests/test_torch_wkv_split.py`` holds
that split to the plain version's bits on the CPU).
:func:`rwkv6_chunked_plain` is the chunked-parallel form of the same
function, which the model uses for ``cfg.rwkv_impl == "chunked"``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: state sizes the kernel is instantiated for: K = V = 64 is rwkv6-7b's
#: head, 16 and 32 the JAX kernel tests' smaller heads
KERNEL_SIZES = (16, 32, 64)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 as a pairwise tree: row j plus row j + n/2, halving
    n (an odd row out is carried to the next level).  Each add is its own
    rounded op; the kernel sums in the same order."""
    while x.shape[-2] > 1:
        n = x.shape[-2]
        half = n // 2
        y = x[..., :half, :] + x[..., half:2 * half, :]
        x = torch.cat([y, x[..., 2 * half:, :]], dim=-2) if n % 2 else y
    return x[..., 0, :]


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     initial_state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rwkv6_scan`, on any device: a loop over T
    in float32, the JAX package's ``ref.rwkv6`` step for step, with the
    K-sum of ``o`` as a pairwise tree (:func:`_tree_sum`) where JAX has an
    einsum.  Every product and sum is its own rounded op, in the order the
    kernel rounds them, so the two agree bit for bit."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    f32 = torch.float32
    s = torch.zeros((b, h, kk, vv), dtype=f32, device=r.device) \
        if initial_state is None else initial_state.float()
    uu = u.float()[None, :, :, None]
    out = torch.empty((b, h, t, vv), dtype=v.dtype, device=v.device)
    for i in range(t):
        r_t, k_t = r[:, :, i].float(), k[:, :, i].float()
        v_t, w_t = v[:, :, i].float(), w[:, :, i].float()
        kv = k_t[..., :, None] * v_t[..., None, :]          # [B,H,K,V]
        att = s + uu * kv
        out[:, :, i] = _tree_sum(r_t[..., :, None] * att).to(v.dtype)
        s = w_t[..., :, None] * s + kv
    return out, s


def rwkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, *, chunk: int = 32,
                        initial_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence in chunked-parallel form, the JAX package's
    ``ref.rwkv6_chunked``: the state is read and written once per chunk,
    and the work inside a chunk is three matrix products.  Within a chunk
    the decays are factored as ``r_t * exp(logA_{t-1})`` and
    ``k_s * exp(-logA_s)``, which stays inside float32 range for chunks
    of at most 64 steps.  T must be a multiple of ``min(chunk, T)``."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    f32 = torch.float32
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of the chunk "
                         f"{chunk}")
    n = t // chunk
    s = torch.zeros((b, h, kk, vv), dtype=f32, device=r.device) \
        if initial_state is None else initial_state.float()

    def split(x):
        return x.reshape(b, h, n, chunk, -1).float()

    rs, ks, vs, ws = split(r), split(k), split(v), split(w)
    uu = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    outs = []
    for c in range(n):
        rc, kc, vc, wc = rs[:, :, c], ks[:, :, c], vs[:, :, c], ws[:, :, c]
        lw = torch.log(wc)
        log_a = torch.cumsum(lw, dim=2)                  # inclusive
        qp = rc * torch.exp(log_a - lw)
        kp = kc * torch.exp(-log_a)
        p = torch.einsum("bhtk,bhsk->bhts", qp, kp)
        p = torch.where(mask, p, torch.zeros((), dtype=f32, device=p.device))
        o = torch.einsum("bhts,bhsv->bhtv", p, vc)
        diag = torch.sum(rc * uu[None, :, None, :] * kc, dim=-1)
        o = o + diag[..., None] * vc
        o = o + torch.einsum("bhtk,bhkv->bhtv", qp, s)
        a_c = torch.exp(log_a[:, :, -1])                 # [B,H,K]
        s = a_c[..., :, None] * s + torch.einsum(
            "bhsk,bhsv->bhkv", kp * a_c[..., None, :], vc)
        outs.append(o)
    return torch.cat(outs, dim=2).to(v.dtype), s


def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv6_scan")
    if lib.rwkv6_scan.argtypes is None:
        lib.rwkv6_scan.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        lib.rwkv6_scan.restype = ctypes.c_int
    return lib


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: [B, H, T, K]; v: [B, H, T, V]; u: [H, K] ->
    (o [B, H, T, V] in v's dtype, final state [B, H, K, V] float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  r, k and v share one dtype (float32 or bfloat16);
    w and u are float32.  Any strides over B, H and T whose rows start
    16-byte aligned (a ``ValueError`` names the tensor otherwise); a last
    dim that is not contiguous is copied.
    """
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u)
    build.refuse_grad(rwkv6_scan, r, k, v, w, u)
    lib = _lib()
    if not all(x.is_cuda for x in (r, k, v, w, u)):
        raise ValueError("rwkv6 scan kernel needs CUDA tensors")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype or w.dtype != torch.float32 \
            or u.dtype != torch.float32:
        raise ValueError(f"kernel takes r, k, v of one dtype (float32 or "
                         f"bfloat16) and float32 w, u; got {r.dtype}/"
                         f"{k.dtype}/{v.dtype}/{w.dtype}/{u.dtype}")
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"need r, k, w [B, H, T, K] and v [B, H, T, V]; "
                         f"got {tuple(r.shape)} {tuple(k.shape)} "
                         f"{tuple(w.shape)} {tuple(v.shape)}")
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    if tuple(u.shape) != (h, kk):
        raise ValueError(f"need u [{h}, {kk}], got {tuple(u.shape)}")
    if kk not in KERNEL_SIZES or vv not in KERNEL_SIZES:
        raise ValueError(f"kernel takes K and V in {KERNEL_SIZES}, got "
                         f"K {kk}, V {vv}")
    r, k, v, w = (x if x.stride(-1) == 1 else x.contiguous()
                  for x in (r, k, v, w))
    u = u.contiguous()
    # the kernel copies rows into shared memory 16 bytes at a time
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.data_ptr() % 16 or any(
                x.stride(d) * x.element_size() % 16
                for d in range(3) if x.shape[d] > 1):
            raise ValueError(
                f"rows of {name} {tuple(x.shape)} (strides {x.stride()}, "
                f"{x.dtype}) are not 16-byte aligned; the kernel reads "
                f"them by 16-byte copies")
    o = torch.empty((b, h, t, vv), dtype=v.dtype, device=v.device)
    s = torch.zeros((b, h, kk, vv), dtype=torch.float32, device=v.device)
    if b == 0 or h == 0 or t == 0:
        return o, s
    strides = [x.stride(d) for x in (r, k, v, w) for d in (0, 1, 2)]
    build.launch(
        lib.rwkv6_scan, v.device,
        _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), o.data_ptr(), s.data_ptr(),
        b, h, t, kk, vv, *strides)
    build.count_launch(rwkv6_scan)
    return o, s


rwkv6_scan.launches = 0

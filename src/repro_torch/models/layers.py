"""Model building blocks for the paged decoder: norm, RoPE, GQA attention
against the block pool, SwiGLU MLP, embed and unembed.

Functions on tensors with parameters in plain dicts, as in the JAX
package's ``models/layers.py``; layer parameters are stacked ``[L, ...]``
by the model and sliced per layer.  Matrix products outside the kernels
go to ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return float(theta) ** exps


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, H, T, hd]; positions: [B, T] absolute positions."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)                   # [hd/2]
    angles = positions[:, None, :, None].float() * freqs       # [B,1,T,hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, t, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return q, k, v


def attention_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, positions: torch.Tensor,
                    last_idx: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Attention for chunked prefill / decode against a paged KV pool.

    x: [B, C, D] new tokens; k_pool / v_pool: [N, Hkv, bs, hd] (one
    layer's slice of the pool); block_tables: [B, M]; positions: [B, C];
    last_idx: optional [B] index of each row's last valid token — tokens
    past it are padding and their K/V go to the null block (block 0).

    The new K/V are written into the pool IN PLACE (the JAX version
    returns an updated copy; here the pool buffers are updated where they
    live, which saves a pool-sized copy per step), then the queries attend
    over the row's table.  Returns (out [B, C, D], (k_pool, v_pool)).
    """
    b, c, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    bs = k_pool.shape[2]
    m = block_tables.shape[1]
    # clamp: padded prefill positions past the table write into whatever
    # the padding entries point at (the null block) and are never read
    pos = positions.clamp(0, m * bs - 1)
    blk = torch.gather(block_tables.long(), 1, pos.long() // bs)  # [B, C]
    slot = pos.long() % bs
    if last_idx is not None:
        # a decode row in a C-wide step must not let its C-1 padding
        # tokens overwrite the real K/V it just wrote at the same position
        valid = torch.arange(c, device=x.device)[None, :] \
            <= last_idx.long()[:, None]
        blk = torch.where(valid, blk, torch.zeros_like(blk))
        slot = torch.where(valid, slot, torch.zeros_like(slot))
    kk = k_new.transpose(1, 2).reshape(b * c, cfg.num_kv_heads, cfg.head_dim)
    vv = v_new.transpose(1, 2).reshape(b * c, cfg.num_kv_heads, cfg.head_dim)
    bidx, sidx = blk.reshape(-1), slot.reshape(-1)
    k_pool[bidx, :, sidx, :] = kk.to(k_pool.dtype)
    v_pool[bidx, :, sidx, :] = vv.to(v_pool.dtype)
    o = ops.paged_attention(q, k_pool, v_pool, block_tables, pos,
                            impl=cfg.attention_impl)
    o = o.to(x.dtype).transpose(1, 2).reshape(b, c, cfg.q_dim)
    return o @ p["wo"], (k_pool, v_pool)


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = x @ p["w_gate"]
    act = F.gelu(gate, approximate="tanh") if cfg.mlp_act == "geglu" \
        else F.silu(gate)
    return (act * (x @ p["w_up"])) @ p["w_down"]


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["embed"][tokens]
    if cfg.tie_embeddings:
        # gemma-style scale, rounded to the activation dtype first as the
        # JAX model rounds it (a host scalar: no device round trip)
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embed"].t()
    else:
        logits = x @ p["lm_head"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits

"""Model building blocks: norms, RoPE and M-RoPE, GQA attention
(full-sequence, dense prefill and cached decode, and against the paged
block pool), cross-attention, SwiGLU/GeGLU MLP, embed and unembed, and the
seeded initializer.

Functions on tensors with parameters in plain dicts, as in the JAX
package's ``models/layers.py``; layer parameters are stacked ``[L, ...]``
by the model and sliced per layer.  Matrix products outside the kernels
go to ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.flash_attention import flash_attention_plain
from . import sharded as SH
from .sharded import placed_like

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Initializer:
    """Seeded parameter draws on one device, with the JAX init's
    distributions: dense ``N(0, 1) / sqrt(d_in)``, embedding
    ``N(0, 0.02^2)``, zero biases, unit norms.  Draws are float32 and cast
    to ``dtype``; a leading ``n`` stacks ``n`` layers, drawn one at a time
    so the float32 scratch stays one layer's size.  (The two frameworks
    draw different numbers from one seed; tests that need equal weights
    pass the JAX params through
    :func:`repro_torch.checkpoint.bridge.params_from_numpy`.)"""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def normal(self, shape: Sequence[int], std: float,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return (torch.randn(tuple(shape), generator=self.gen,
                            device=self.device, dtype=torch.float32)
                * std).to(dtype or self.dtype)

    def stacked(self, n: Optional[int], draw) -> torch.Tensor:
        """``draw()`` once (``n`` None) or ``n`` times into one stacked
        tensor."""
        if n is None:
            return draw()
        first = draw()
        out = torch.empty((n, *first.shape), dtype=first.dtype,
                          device=self.device)
        out[0] = first
        for i in range(1, n):
            out[i] = draw()
        return out

    def dense(self, n: Optional[int], d_in: int, d_out: int,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self.stacked(n, lambda: self.normal((d_in, d_out),
                                                   d_in ** -0.5, dtype))

    def uniform(self, n: Optional[int], shape: Sequence[int], lo: float,
                hi: float) -> torch.Tensor:
        """float32 ``U(lo, hi)``, kept in float32."""
        return self.stacked(n, lambda: torch.rand(
            tuple(shape), generator=self.gen, device=self.device,
            dtype=torch.float32) * (hi - lo) + lo)

    def _lead(self, n: Optional[int], shape: Sequence[int]):
        return tuple(shape) if n is None else (n, *shape)

    def zeros(self, n: Optional[int], *shape: int) -> torch.Tensor:
        return torch.zeros(self._lead(n, shape), dtype=self.dtype,
                           device=self.device)

    def ones(self, n: Optional[int], *shape: int) -> torch.Tensor:
        return torch.ones(self._lead(n, shape), dtype=self.dtype,
                          device=self.device)

    def attention(self, n: Optional[int], cfg: ModelConfig) -> Params:
        p = {"wq": self.dense(n, cfg.d_model, cfg.q_dim),
             "wk": self.dense(n, cfg.d_model, cfg.kv_dim),
             "wv": self.dense(n, cfg.d_model, cfg.kv_dim),
             "wo": self.dense(n, cfg.q_dim, cfg.d_model)}
        if cfg.qkv_bias:
            p.update(bq=self.zeros(n, cfg.q_dim), bk=self.zeros(n, cfg.kv_dim),
                     bv=self.zeros(n, cfg.kv_dim))
        return p

    def cross_attention(self, n: Optional[int], cfg: ModelConfig) -> Params:
        """The encoder-decoder's cross-attention: no biases."""
        return {"wq": self.dense(n, cfg.d_model, cfg.q_dim),
                "wk": self.dense(n, cfg.d_model, cfg.kv_dim),
                "wv": self.dense(n, cfg.d_model, cfg.kv_dim),
                "wo": self.dense(n, cfg.q_dim, cfg.d_model)}

    def moe(self, n: Optional[int], cfg: ModelConfig) -> Params:
        """Stacked experts ``[E, d, fe]`` / ``[E, fe, d]`` with the dense
        scales, the float32 router ``[d, E]`` (float32 at any model dtype,
        as in JAX), and the shared experts as one ``fe * num_shared``-wide
        MLP."""
        m, d = cfg.moe, cfg.d_model
        fe, e = m.d_expert, m.num_experts
        p = {"router": self.dense(n, d, e, torch.float32),
             "w_gate": self.stacked(n, lambda: self.normal((e, d, fe),
                                                           d ** -0.5)),
             "w_up": self.stacked(n, lambda: self.normal((e, d, fe),
                                                         d ** -0.5)),
             "w_down": self.stacked(n, lambda: self.normal((e, fe, d),
                                                           fe ** -0.5))}
        if m.num_shared:
            fs = fe * m.num_shared
            p["shared"] = {"w_gate": self.dense(n, d, fs),
                           "w_up": self.dense(n, d, fs),
                           "w_down": self.dense(n, fs, d)}
        return p

    def mlp(self, n: Optional[int], cfg: ModelConfig) -> Params:
        return {"w_gate": self.dense(n, cfg.d_model, cfg.d_ff),
                "w_up": self.dense(n, cfg.d_model, cfg.d_ff),
                "w_down": self.dense(n, cfg.d_ff, cfg.d_model)}

    def embedding(self, cfg: ModelConfig) -> Params:
        p = {"embed": self.normal((cfg.vocab_size, cfg.d_model), 0.02)}
        if not cfg.tie_embeddings:
            p["lm_head"] = self.normal((cfg.d_model, cfg.vocab_size),
                                       cfg.d_model ** -0.5)
        return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """Per-head group norm (the RWKV6 output norm).  x: [..., D]."""
    orig = x.shape
    xf = x.float().reshape(*orig[:-1], num_groups, -1)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(orig)
    return (y * scale.float() + bias.float()).to(x.dtype)


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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: three position axes (t, h, w) over head_dim
    sections.  x: [B, H, T, hd]; positions3: [3, B, T].  ``sections``
    partitions the hd/2 frequencies; section i rotates by
    ``positions3[i]``."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim {hd} // 2")
    freqs = _rope_freqs(hd, theta, x.device)                   # [hd/2]
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # [hd/2]
    pos = positions3[sec_id]                                   # [hd/2,B,T]
    angles = pos.permute(1, 2, 0).float() * freqs              # [B,T,hd/2]
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def merge_heads(o: torch.Tensor, x: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """[B, H, T, hd] -> [B, T, H * hd], the input of the row-parallel
    output projection (on DTensors placed as the column-parallel
    ``x @ w`` placed its features)."""
    b, h, t, hd = o.shape
    return SH.like_columns(o.transpose(1, 2).reshape(b, t, h * hd), x, w)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, t, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    # q's heads split into (kv heads, group) in the attention, so all
    # three need the kv heads to divide
    q, k, v = (SH.even_heads(y, cfg.num_kv_heads) for y in (q, k, v))
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return q, k, v


def _pos_embed(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    """RoPE at positions [B, T], or M-RoPE at positions [3, B, T]."""
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta,
                            cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ModelConfig, *, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    """Full-sequence attention: the query-chunked plain path for long
    sequences under ``attention_impl="reference"`` (as in JAX), else
    ``ops.attention``, which takes the flash kernel on the card."""
    if isinstance(q, DTensor):
        # the dry run's sharded step: attention is independent across
        # batch rows and heads, so it runs on each rank's shard (DTensor
        # cannot batch a product over two sharded dims)
        heads = {0: 0, 1: 1}
        return SH.on_shards(
            lambda q, k, v: (_attend(q, k, v, cfg, causal=causal,
                                     window=window),),
            (q, k, v), (0, 1), (heads,))[0]
    if q.shape[2] >= cfg.attention_chunk_threshold \
            and cfg.attention_impl == "reference":
        return _chunked_attention(q, k, v, cfg, causal=causal, window=window)
    return ops.attention(q, k, v, causal=causal, window=window,
                         impl=cfg.attention_impl)


def attention_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (scoring; training in JAX)."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _pos_embed(q, k, cfg, positions)
    o = _attend(q, k, v, cfg, causal=causal, window=window)
    return placed_like(merge_heads(o, x, p["wq"]) @ p["wo"], x)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: ModelConfig, *, causal: bool,
                       window: Optional[int]) -> torch.Tensor:
    """Q-chunked plain attention: scores materialize ``[*, q_chunk, S]``
    at a time (a loop over query chunks takes the place of the JAX scan).
    With a window, a chunk starting at ``p`` attends only to the KV span
    ``[p - window, p + q_chunk)``, clamped into the sequence."""
    b, h, t, d = q.shape
    qc = min(cfg.attention_q_chunk, t)
    if t % qc:
        raise ValueError(f"sequence {t} is not a multiple of the query "
                         f"chunk {qc}")
    s_len = k.shape[2]
    outs = []
    for idx in range(t // qc):
        qblk = q[:, :, idx * qc:(idx + 1) * qc]
        if window is not None and window + qc < s_len:
            span = window + qc
            start = min(max(idx * qc - window, 0), s_len - span)
            o = flash_attention_plain(
                qblk, k[:, :, start:start + span], v[:, :, start:start + span],
                causal=causal, window=window, q_offset=idx * qc - start)
        else:
            o = flash_attention_plain(qblk, k, v, causal=causal,
                                      window=window, q_offset=idx * qc)
        outs.append(o)
    return torch.cat(outs, dim=2)


def attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, cache_len: int, *,
                      window: Optional[int] = None):
    """Prefill: full-sequence causal attention that also returns the KV
    cache, k/v ``[B, Hkv, max(cache_len, T), hd]`` with the first T slots
    filled (padded to ``cache_len`` only when T is shorter, as in JAX)."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _pos_embed(q, k, cfg, positions)
    o = _attend(q, k, v, cfg, causal=True, window=window)
    out = placed_like(merge_heads(o, x, p["wq"]) @ p["wo"], x)
    pad = cache_len - t
    if pad > 0:
        k, v = SH.pad_slots(k, v, pad)
    return out, {"k": k.contiguous(), "v": v.contiguous()}


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], pos: int, *,
                     window: Optional[int] = None):
    """Single-token decode against a KV cache, updated IN PLACE.

    x: [B, 1, D]; cache k/v: [B, Hkv, S, hd]; pos: absolute position of
    the new token (a host int).  A local-attention cache exactly
    ``window`` long is a ring (slot ``pos % window``).  Otherwise the new
    K/V go to slot ``min(pos, S - 1)``: JAX's ``dynamic_update_slice``
    clamps its start index, so past the cache every token overwrites the
    last slot and all ``S`` slots take part.  Returns (out [B, 1, D],
    cache).
    """
    b, t, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg)
    bpos = torch.full((b, t), pos, dtype=torch.int64, device=x.device)
    if cfg.mrope:   # every axis at pos, as in JAX
        bpos = bpos.expand(3, b, t)
    q, k_new = _pos_embed(q, k_new, cfg, bpos)
    k, v = cache["k"], cache["v"]
    s = k.shape[2]
    if window is not None and s == window:
        slot = pos % window
        # slot i holds absolute position pos - ((slot - i) mod window)
        idx = torch.arange(window, device=x.device)
        valid = (pos - torch.remainder(slot - idx, window)) >= 0
    else:
        slot = min(pos, s - 1)
        valid = torch.arange(s, device=x.device) <= pos
    SH.write_slot(k, k_new, slot)
    SH.write_slot(v, v_new, slot)
    if isinstance(q, DTensor) and Shard(2) not in k.placements:
        # the dry run's sharded step with the cache split by batch and
        # heads: each rank attends over its shard (DTensor cannot batch a
        # product over two sharded dims); a cache split along the sequence
        # stays a DTensor product, its softmax gathering the scores
        heads = {0: 0, 1: 1}
        o = SH.on_shards(lambda q, k, v: (_decode_attend(q, k, v, cfg,
                                                          valid),),
                          (q, k, v), (0, 1), (heads,))[0]
    else:
        o = _decode_attend(q, k, v, cfg, valid)
    return placed_like(merge_heads(o.to(x.dtype), x, p["wq"]) @ p["wo"],
                       x), cache


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig, valid: torch.Tensor) -> torch.Tensor:
    """Masked decode attention over the cache slots where ``valid``
    [S]."""
    b, hq, t, hd = q.shape
    hkv = k.shape[1]
    qr = q.reshape(b, hkv, hq // hkv, t, hd)
    logits = torch.einsum("bhgqd,bhsd->bhgqs", qr.float(),
                          k.float()) * cfg.head_dim ** -0.5
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqs,bhsd->bhgqd", probs, v.float())
    return o.reshape(b, hq, t, hd)


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
    q, k_new = _pos_embed(q, k_new, cfg, positions)
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


def cross_attention(p: Params, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Non-causal attention of decoder states x [B, T, D] over the encoder
    memory [B, S, D] (no position embedding, no biases)."""
    b, t, _ = x.shape
    s = memory.shape[1]
    q = SH.even_heads(x @ p["wq"], cfg.num_kv_heads) \
        .reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = SH.even_heads(memory @ p["wk"], cfg.num_kv_heads) \
        .reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = SH.even_heads(memory @ p["wv"], cfg.num_kv_heads) \
        .reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    o = _attend(q, k, v, cfg, causal=False, window=None)
    return placed_like(merge_heads(o, x, p["wq"]) @ p["wo"], x)


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = x @ p["w_gate"]
    act = F.gelu(gate, approximate="tanh") if cfg.mlp_act == "geglu" \
        else F.silu(gate)
    return placed_like((act * (x @ p["w_up"])) @ p["w_down"], x)


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if isinstance(p["embed"], DTensor):
        # vocab-parallel lookup (masked local rows, then one reduction of
        # [B, T, D]); indexing would gather the whole table first
        x = F.embedding(tokens, p["embed"])
    else:
        x = p["embed"][tokens]
    if cfg.tie_embeddings:
        # gemma-style scale, rounded to the activation dtype first as the
        # JAX model rounds it (a host scalar: no device round trip)
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return placed_like(x, tokens)


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    if isinstance(x, DTensor):
        # one product over the flattened rows: a prefill's last position
        # x[:, -1:] is strided, and a DTensor product would batch over a
        # copy of the weight for every row
        logits = (x.reshape(-1, x.shape[-1]) @ w).view(*x.shape[:-1],
                                                       w.shape[-1])
    else:
        logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _nll_sum(lf: torch.Tensor, labels: torch.Tensor):
    """(sum of -log p(label), count of labels) over float32 logits
    ``[..., V]``; a label of -1 is ignored."""
    idx = labels.clamp_min(0).long()[..., None]
    if isinstance(lf, DTensor):
        lse, picked = SH.vocab_parallel_nll(lf, idx, labels)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        picked = torch.gather(lf, -1, idx)[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - picked) * mask), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE in float32.  logits: [B, T, V]; labels: [B, T] (-1 = ignore)."""
    total, count = _nll_sum(logits.float(), labels)
    return total / count.clamp_min(1.0)


def chunked_loss(p: Params, x: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, chunk: int) -> torch.Tensor:
    """Sequence-chunked vocab loss: the unembed and CE run ``chunk``
    positions at a time, so the ``[B, chunk, V]`` logits are the largest
    buffer (a loop over chunks takes the place of the JAX scan).  T is a
    multiple of ``chunk``, as the JAX reshape requires."""
    b, t, _ = x.shape
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of the loss "
                         f"chunk {chunk}")
    total = count = 0.0
    for s in range(0, t, chunk):
        n, c = _nll_sum(unembed(p, x[:, s:s + chunk], cfg).float(),
                        labels[:, s:s + chunk])
        total, count = total + n, count + c
    return total / torch.clamp_min(count, 1.0)

"""RWKV6 (Finch) blocks: token-shift time-mix with a data-dependent decay,
and a squared-ReLU channel-mix [arXiv:2404.05892].

    ddlerp token shift: x_i = x + (x_prev - x) * (mu_i + lora_i(x_mix))
    decay:              w = exp(-exp(w0 + tanh(x_w @ A_w) @ B_w))
    WKV:                per-head linear attention with bonus u and decay w
    output:             per-head GroupNorm, silu gate, w_o
    channel mix:        sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)

A port of the JAX package's ``models/rwkv6.py`` with its cast points:
the decay and u are float32 whatever the model dtype, the WKV output
returns to the model dtype before the group norm.  The decode state per
layer is ``{"shift_t", "shift_c"}`` ``[B, 1, D]`` in the model dtype and
``"wkv"`` ``[B, H, K, V]`` float32.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.rwkv6_scan import rwkv6_chunked_plain
from . import sharded as SH
from .layers import Initializer, Params, group_norm, layer_norm
from .sharded import placed_like


def init_rwkv_block(init: Initializer, n: Optional[int],
                    cfg: ModelConfig) -> Params:
    """One RWKV6 layer's parameters (``n`` stacks ``n`` of them), with the
    JAX init's distributions; every leaf in the model dtype."""
    d = cfg.d_model
    ext, dext = cfg.time_mix_extra_dim, cfg.decay_extra_dim
    hd = cfg.rwkv_head_dim

    def normal(shape, std):
        return init.stacked(n, lambda: init.normal(shape, std))

    return {
        "ln1_s": init.ones(n, d), "ln1_b": init.zeros(n, d),
        "ln2_s": init.ones(n, d), "ln2_b": init.zeros(n, d),
        # token-shift base mixes
        "mu_x": init.zeros(n, d),
        "mu": init.zeros(n, 5, d),
        # ddlerp low-rank adapters: one A, per-target B
        "lora_A": normal((d, 5 * ext), 1e-2),
        "lora_B": normal((5, ext, d), 1e-2),
        # time-mix projections
        "wr": init.dense(n, d, d), "wk": init.dense(n, d, d),
        "wv": init.dense(n, d, d), "wg": init.dense(n, d, d),
        "wo": init.dense(n, d, d),
        # data-dependent decay
        "w0": init.ones(n, d) * -6.0,
        "wdecay_A": normal((d, dext), 1e-2),
        "wdecay_B": normal((dext, d), 1e-2),
        # per-head bonus
        "u": normal((d // hd, hd), 0.1),
        "gn_s": init.ones(n, d), "gn_b": init.zeros(n, d),
        # channel-mix
        "mu_ck": init.zeros(n, d), "mu_cr": init.zeros(n, d),
        "wck": init.dense(n, d, cfg.d_ff),
        "wcv": init.dense(n, cfg.d_ff, d),
        "wcr": init.dense(n, d, d),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """The previous token's activation ([B, T, D] shifted by one)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    # a decode state arrives placed by the cache's specs (channels over
    # the model axis); the dry run's sharded step places it as x
    return torch.cat([placed_like(prev, x), x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, xx: torch.Tensor):
    """Data-dependent token-shift mixes for (r, k, v, w, g)."""
    delta = xx - x
    x_mix = x + delta * p["mu_x"]
    ext = p["lora_A"].shape[1] // 5
    lora = torch.tanh(x_mix @ p["lora_A"])                  # [B,T,5*ext]
    b, t, _ = x.shape
    lora = lora.reshape(b, t, 5, ext)
    adj = torch.einsum("btie,ied->btid", lora, p["lora_B"])  # [B,T,5,D]
    mixed = x[:, :, None] + delta[:, :, None] * (p["mu"] + adj)
    # each mix feeds a column-parallel projection: on DTensors its
    # gradient is reduced back to x's layout here (a no-op on plain)
    return tuple(placed_like(mixed[:, :, i], x) for i in range(5))


def _wkv_step(r, k, v, w, s, u):
    """One decode step of the WKV recurrence in closed form: r, k, v, w
    [B, H, 1, K], state s [B, H, K, V] -> (o [B, H, 1, V], new state)."""
    r1, k1 = r[:, :, 0].float(), k[:, :, 0].float()
    v1, w1 = v[:, :, 0].float(), w[:, :, 0]
    kv = k1[..., :, None] * v1[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r1, s + u[None, :, :, None] * kv)
    return o[:, :, None], w1[..., :, None] * s + kv


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
             shift_state: Optional[torch.Tensor] = None,
             wkv_state: Optional[torch.Tensor] = None):
    """The attention replacement.  Returns (out, new shift, new WKV state).

    Three branches, on JAX's conditions: one token with a state (decode)
    is a closed-form step; otherwise ``cfg.rwkv_impl == "chunked"`` takes
    the chunked plain form, and anything else ``ops.rwkv6`` with
    ``impl=cfg.attention_impl`` (the kernel on the card; the JAX model
    calls its scan with no impl).  r, k, v and w reach the scan as
    ``[B, H, T, K]`` views of the ``[B, T, H, K]`` projections.
    """
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xx = _shift(x, shift_state)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)
    r = (xr @ p["wr"]).reshape(b, t, h, hd).transpose(1, 2)
    k = (xk @ p["wk"]).reshape(b, t, h, hd).transpose(1, 2)
    v = (xv @ p["wv"]).reshape(b, t, h, hd).transpose(1, 2)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay, per channel, in float32
    w_log = p["w0"].float() \
        + (torch.tanh(xw @ p["wdecay_A"]) @ p["wdecay_B"]).float()
    w = torch.exp(-torch.exp(w_log))                         # (0, 1)
    w = w.reshape(b, t, h, hd).transpose(1, 2)
    u = p["u"].float()
    if t == 1 and wkv_state is not None:
        fn, xs = _wkv_step, (r, k, v, w, wkv_state)
    elif cfg.rwkv_impl == "chunked":
        fn, xs = partial(rwkv6_chunked_plain, chunk=cfg.rwkv_chunk), \
            (r, k, v, w)
    else:
        fn, xs = partial(ops.rwkv6, impl=cfg.attention_impl), (r, k, v, w)
    if isinstance(r, DTensor):
        # the recurrence runs on each rank's rows and heads
        heads = {0: 0, 1: 1}
        o, new_state = SH.on_shards(fn, xs, (0, 1), (heads, heads),
                                    extra=(u, {1: 0}))
    else:
        o, new_state = fn(*xs, u)
    o = o.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    o = group_norm(o, p["gn_s"], p["gn_b"], h, cfg.norm_eps)
    out = placed_like((o * g.to(o.dtype)) @ p["wo"], x)
    return out, x[:, -1], new_state


def channel_mix(p: Params, x: torch.Tensor, *,
                shift_state: Optional[torch.Tensor] = None):
    xx = _shift(x, shift_state)
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    k = torch.square(F.relu(xk @ p["wck"]))
    kv = k @ p["wcv"]
    out = placed_like(torch.sigmoid(xr @ p["wcr"]) * kv, x)
    return out, x[:, -1]


def rwkv_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Dict[str, torch.Tensor]] = None):
    """One RWKV6 layer.  state: {"shift_t", "shift_c", "wkv"} for decode.
    Returns (x, new state)."""
    st = state or {}
    h1 = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    att, shift_t, wkv = time_mix(p, h1, cfg, shift_state=st.get("shift_t"),
                                 wkv_state=st.get("wkv"))
    x = x + att
    h2 = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
    ffn, shift_c = channel_mix(p, h2, shift_state=st.get("shift_c"))
    x = x + ffn
    return x, {"shift_t": shift_t[:, None], "shift_c": shift_c[:, None],
               "wkv": wkv}


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return {
        "shift_t": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                           device=device),
    }

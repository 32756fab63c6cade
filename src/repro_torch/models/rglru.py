"""Griffin recurrent block (RecurrentGemma): conv1d + RG-LRU, gated.

    branch_gate = gelu(x @ w_gate)                       [B, T, lru]
    branch_rec  = rglru(conv1d_causal(x @ w_rec))        [B, T, lru]
    out         = (branch_gate * branch_rec) @ w_out     [B, T, D]

RG-LRU (arXiv:2402.19427):
    i_t = sigmoid(x_t @ W_i + b_i)          input gate
    r_t = sigmoid(x_t @ W_r + b_r)          recurrence gate
    log_a_t = -c * softplus(Lambda) * r_t   (c = 8)
    a_t = exp(log_a_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A port of the JAX package's ``models/rglru.py``.  Lambda and the state h
are float32 whatever the model dtype.  Decode state per layer: conv tail
``[B, conv_width-1, lru]`` + h ``[B, lru]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..kernels import ops
from . import sharded as SH
from .layers import Initializer, Params
from .sharded import placed_like

_C = 8.0


def init_recurrent_block(init: Initializer, n: Optional[int],
                         cfg: ModelConfig) -> Params:
    """One recurrent block's parameters (``n`` stacks ``n`` of them), with
    the JAX init's distributions; ``lam`` is float32 ``U(2, 6)``, so that
    ``a^c`` lies in [0.9, 0.999] at init."""
    d = cfg.d_model
    lru = cfg.lru_width or d
    w = cfg.conv_width
    return {
        "w_gate": init.dense(n, d, lru),
        "w_rec": init.dense(n, d, lru),
        "conv": init.stacked(n, lambda: init.normal((w, lru),
                                                    (w * lru) ** -0.5)),
        "conv_b": init.zeros(n, lru),
        "w_i": init.dense(n, lru, lru),
        "b_i": init.zeros(n, lru),
        "w_r": init.dense(n, lru, lru),
        "b_r": init.zeros(n, lru),
        "lam": init.uniform(n, (lru,), 2.0, 6.0),
        "w_out": init.dense(n, lru, d),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Per-channel causal conv over time.  x: [B, T, C]; kernel: [W, C].
    Returns (out [B, T, C], new tail [B, W-1, C])."""
    w = kernel.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                  # [B, T+W-1, C]
    out = torch.zeros_like(x)
    for i in range(w):   # W taps, depthwise
        out = out + xp[:, i:i + x.shape[1]] * kernel[i]
    new_tail = xp[:, -(w - 1):].contiguous() if w > 1 else tail
    return out + bias, new_tail


def rglru_gates(p: Params, x: torch.Tensor):
    """x: [B, T, lru] (post-conv).  Returns (a, gated_input), float32."""
    i = torch.sigmoid(x @ p["w_i"] + p["b_i"]).float()
    r = torch.sigmoid(x @ p["w_r"] + p["b_r"]).float()
    log_a = -_C * F.softplus(p["lam"].float()) * r     # [B, T, lru]
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    gated = scale * i * x.float()
    return a, gated


def recurrent_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    state: Optional[Dict[str, torch.Tensor]] = None):
    """Returns (out [B, T, D], new_state {conv, h}).

    A one-token step with a state (decode) is one multiply-add inline; a
    sequence runs the RG-LRU scan through ``ops.rglru`` with
    ``impl=cfg.attention_impl`` (the kernel on the card; the JAX model
    calls its scan with no impl).
    """
    st = state or {}
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    rec_in = x @ p["w_rec"]
    rec_in, new_conv = _causal_conv(rec_in, p["conv"], p["conv_b"],
                                    st.get("conv"))
    # the gates' products are column-parallel: on DTensors their input
    # (channels split by w_rec) is gathered to the stream's layout first
    a, gated = rglru_gates(p, placed_like(rec_in, x))
    if x.shape[1] == 1 and "h" in st:
        h = a[:, 0] * st["h"] + gated[:, 0]
        rec_out = h[:, None]
        new_h = h
    elif isinstance(gated, DTensor):
        # the scan runs on each rank's rows and channels
        rec_out, new_h = SH.on_shards(
            lambda g, a: ops.rglru(g, a, impl=cfg.attention_impl),
            (gated, a), (0, 2), ({0: 0, 2: 2}, {0: 0, 2: 1}))
    else:
        rec_out, new_h = ops.rglru(gated, a, impl=cfg.attention_impl)
    rec_out = rec_out.to(x.dtype)
    out = placed_like((gate * rec_out) @ p["w_out"], x)
    return out, {"conv": new_conv, "h": new_h}


def init_recurrent_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                         device) -> Dict[str, torch.Tensor]:
    lru = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, lru), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
    }

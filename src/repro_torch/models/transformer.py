"""Decoder-only LM over the paged KV pool (the serving path).

The JAX package's ``DecoderLM`` scans stacked ``[L, ...]`` layer
parameters with ``jax.lax.scan``; here a Python loop over layers takes the
place of the scan and each layer's parameters are views into the same
stacked tensors, so the parameter tree is the JAX one unchanged:
``embed``, ``final_norm``, ``layers/{ln1, ln2, attn/{wq, wk, wv, wo, bq,
bk, bv}, mlp/{w_gate, w_up, w_down}}``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L

Params = Dict[str, Any]


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def decoder_layer_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        block_tables: torch.Tensor, positions: torch.Tensor,
                        last_idx=None):
    """One decoder layer against a paged KV pool (prefill chunk, decode,
    or a mixed prefill/decode step with per-row token counts)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    att, pools = L.attention_paged(p["attn"], h, cfg, k_pool, v_pool,
                                   block_tables, positions,
                                   last_idx=last_idx)
    x = x + att
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg), pools


class DecoderLM:
    """Decoder-only LM (dense GQA family) on the paged serving path."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init(self, seed: int, device: torch.device) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on ``device``,
        with the JAX init's distributions: dense ``N(0, 1) / sqrt(d_in)``,
        embedding ``N(0, 0.02^2)``, zero biases, unit norms.  (The two
        frameworks draw different numbers from one seed; tests that need
        equal weights pass the JAX params through
        :func:`repro_torch.checkpoint.bridge.params_from_numpy`.)"""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        n = cfg.num_layers

        def normal(shape, std):
            return (torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32) * std).to(dt)

        def dense(d_in, d_out):
            w = torch.empty((n, d_in, d_out), dtype=dt, device=device)
            for i in range(n):   # one layer at a time: small fp32 scratch
                w[i] = normal((d_in, d_out), d_in ** -0.5)
            return w

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=device)

        p: Params = {"embed": normal((cfg.vocab_size, cfg.d_model), 0.02)}
        if not cfg.tie_embeddings:
            p["lm_head"] = normal((cfg.d_model, cfg.vocab_size),
                                  cfg.d_model ** -0.5)
        attn = {"wq": dense(cfg.d_model, cfg.q_dim),
                "wk": dense(cfg.d_model, cfg.kv_dim),
                "wv": dense(cfg.d_model, cfg.kv_dim),
                "wo": dense(cfg.q_dim, cfg.d_model)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(n, cfg.q_dim), bk=zeros(n, cfg.kv_dim),
                        bv=zeros(n, cfg.kv_dim))
        p["layers"] = {
            "ln1": ones(n, cfg.d_model), "ln2": ones(n, cfg.d_model),
            "attn": attn,
            "mlp": {"w_gate": dense(cfg.d_model, cfg.d_ff),
                    "w_up": dense(cfg.d_model, cfg.d_ff),
                    "w_down": dense(cfg.d_ff, cfg.d_model)}}
        p["final_norm"] = ones(cfg.d_model)
        return p

    # -- paged serving ----------------------------------------------------------
    @property
    def supports_paged(self) -> bool:
        """Paged KV is wired for the standard GQA decoder stack: token
        inputs, global attention, standard RoPE, dense MLP."""
        cfg = self.cfg
        return (cfg.input_kind == "tokens" and not cfg.rwkv
                and cfg.attention_kind == "global" and not cfg.mrope
                and cfg.moe is None)

    def init_paged_pool(self, num_blocks: int, block_size: int,
                        device: torch.device) -> Dict[str, torch.Tensor]:
        """{"k", "v"} zero pools, [L, N, Hkv, bs, hd]: a layer's slice is
        contiguous, which is what the attention kernels read."""
        cfg = self.cfg
        shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
                "v": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)}

    def _paged_backbone(self, params: Params, tokens: torch.Tensor, pool,
                        block_tables: torch.Tensor, positions: torch.Tensor,
                        last_idx: torch.Tensor):
        """Embed, run every layer against the block pool (written in
        place), final norm.  Returns (x [B, C, D], pool)."""
        cfg = self.cfg
        x = L.embed(params, tokens, cfg)
        for i in range(cfg.num_layers):
            x, _ = decoder_layer_paged(_layer(params["layers"], i), x, cfg,
                                       pool["k"][i], pool["v"][i],
                                       block_tables, positions,
                                       last_idx=last_idx)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps), pool

    def paged_step(self, params: Params, tokens: torch.Tensor, pool,
                   block_tables: torch.Tensor, positions: torch.Tensor,
                   last_idx: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Advance up to C tokens per row against the paged pool.

        tokens: [B, C]; pool: {"k","v"} [L, N, Hkv, bs, hd];
        block_tables: [B, M]; positions: [B, C]; last_idx: [B] index of
        each row's last valid token.  Returns (logits [B, V] at last_idx,
        pool) — raw logits; token selection is the scheduler's job.
        """
        x, pool = self._paged_backbone(params, tokens, pool, block_tables,
                                       positions, last_idx)
        idx = last_idx.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x_last = torch.gather(x, 1, idx)                         # [B, 1, D]
        return L.unembed(params, x_last, self.cfg)[:, 0], pool

    def paged_step_verify(self, params: Params, tokens: torch.Tensor, pool,
                          block_tables: torch.Tensor,
                          positions: torch.Tensor, last_idx: torch.Tensor
                          ) -> Tuple[torch.Tensor, Any]:
        """Speculative-decoding verifier: :meth:`paged_step` with logits at
        EVERY chunk position.  ``logits[b, j]`` scores the vocabulary after
        row b consumed tokens 0..j; positions past ``last_idx`` are padding
        the engine never reads.  Returns (logits [B, C, V], pool)."""
        x, pool = self._paged_backbone(params, tokens, pool, block_tables,
                                       positions, last_idx)
        return L.unembed(params, x, self.cfg), pool


def get_model(cfg: ModelConfig) -> DecoderLM:
    if cfg.encoder_layers or cfg.block_pattern or cfg.rwkv:
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder family is ported "
            f"(see ROADMAP.md, Queue 1: other model families)")
    return DecoderLM(cfg)

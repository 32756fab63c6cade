"""Model assembly: the decoder LM (GQA layers with a dense or an MoE FFN,
token or embedding (M-RoPE) inputs, paged serving, dense prefill and
decode and full-sequence logits; or RWKV6 layers with dense serving and
logits), the hybrid LM (RecurrentGemma) and the encoder-decoder LM
(the Seamless backbone).

The JAX package stacks layer parameters ``[L, ...]`` and consumes them
with ``jax.lax.scan``; here a Python loop over layers takes the place of
the scan and each layer's parameters are views into the same stacked
tensors, so the parameter trees are the JAX ones unchanged:
``embed``, ``final_norm``, ``layers/{ln1, ln2, attn/{wq, wk, wv, wo, bq,
bk, bv}, mlp/{w_gate, w_up, w_down}}`` for the decoder (``moe/{router,
w_gate, w_up, w_down, shared}`` in place of ``mlp`` for MoE); ``layers/{ln1_s,
ln1_b, mu_x, mu, lora_A, lora_B, wr, wk, wv, wg, wo, w0, wdecay_A,
wdecay_B, u, gn_s, gn_b, ln2_s, ln2_b, mu_ck, mu_cr, wck, wcv, wcr}`` for
RWKV6 (``lm_head`` untied); ``supers/b{i}`` (stacked over super-blocks)
and ``tail/t{i}`` for the hybrid; ``encoder/{ln1, ln2, attn, mlp}``,
``decoder/{ln1, ln_x, ln2, attn, xattn, mlp}`` and ``enc_norm`` for the
encoder-decoder.  Caches keep the JAX layout too (``k``/``v``
``[L, B, Hkv, S, hd]``, and the encoder ``memory`` ``[B, S_mem, D]``
beside them for the encoder-decoder; RWKV6 ``shift_t``/``shift_c``
``[L, B, 1, D]`` and ``wkv`` ``[L, B, H, K, V]``); decode updates them in
place where JAX returns a new cache.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import moe as M
from . import rglru as R
from . import rwkv6 as W

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i``'s parameters (or cache): views into the stacked
    ``[L, ...]`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(trees) -> Params:
    """Per-layer trees -> one tree of stacked ``[L, ...]`` tensors."""
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in first.items()}


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, t = tokens.shape
    return torch.arange(t, device=tokens.device).expand(b, t)


def _window(cfg: ModelConfig):
    return cfg.window if cfg.attention_kind == "local" else None


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig):
    """The layer's FFN on its normed input: (out, aux loss) — the MoE
    FFN's, or the dense MLP's with aux 0."""
    if cfg.moe is not None:
        return M.moe_ffn(p["moe"], h, cfg)
    return L.mlp(p["mlp"], h, cfg), 0.0


def decoder_layer_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor):
    """Returns (x, aux loss)."""
    if cfg.rwkv:
        return W.rwkv_block(p, x, cfg)[0], 0.0
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_train(p["attn"], h, cfg, positions,
                              window=_window(cfg))
    y, aux = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, aux


def decoder_layer_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, cache_len: int):
    if cfg.rwkv:   # no KV: the cache is the state, cache_len unused
        return W.rwkv_block(p, x, cfg)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    att, kv = L.attention_prefill(p["attn"], h, cfg, positions, cache_len,
                                  window=_window(cfg))
    x = x + att
    y, _ = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, kv


def decoder_layer_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                         cache: Dict[str, torch.Tensor], pos: int):
    if cfg.rwkv:
        x, new = W.rwkv_block(p, x, cfg, state=cache)
        for name, val in new.items():   # write through the view
            cache[name].copy_(val)
        return x, cache
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    att, kv = L.attention_decode(p["attn"], h, cfg, cache, pos,
                                 window=_window(cfg))
    x = x + att
    y, _ = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, kv


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
    y, _ = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, pools


class DecoderLM:
    """Decoder-only LM over homogeneous layers: GQA with a dense or an MoE
    FFN (paged serving steps, dense prefill and decode against a
    ``[L, B, Hkv, S, hd]`` cache, full-sequence logits), from tokens or,
    for ``input_kind="embeddings"`` (qwen2-vl), from ``batch["embeds"]``
    with M-RoPE positions ``batch["positions"]`` [3, B, T] (decode steps
    embed token ids, as in JAX); or RWKV6 (dense prefill and decode
    against the stacked recurrent state, full-sequence logits)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init(self, seed: int, device: torch.device) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device`` (see :class:`~repro_torch.models.layers.Initializer`)."""
        cfg = self.cfg
        init = L.Initializer(seed, device, L.dtype_of(cfg))
        n = cfg.num_layers
        p: Params = init.embedding(cfg)
        if cfg.rwkv:
            p["layers"] = W.init_rwkv_block(init, n, cfg)
        else:
            p["layers"] = {"ln1": init.ones(n, cfg.d_model),
                           "ln2": init.ones(n, cfg.d_model),
                           "attn": init.attention(n, cfg)}
            if cfg.moe is not None:
                p["layers"]["moe"] = init.moe(n, cfg)
            else:
                p["layers"]["mlp"] = init.mlp(n, cfg)
        p["final_norm"] = init.ones(None, cfg.d_model)
        return p

    def _inputs(self, params: Params, batch: Batch):
        """(x [B, T, D], positions): the embeddings and their [3, B, T]
        positions as given, or the embedded tokens at 0..T-1 (on all three
        axes under M-RoPE)."""
        cfg = self.cfg
        if cfg.input_kind == "embeddings":
            return batch["embeds"].to(L.dtype_of(cfg)), batch["positions"]
        tokens = batch["tokens"]
        positions = _positions(tokens)
        if cfg.mrope:
            positions = positions.expand(3, *positions.shape)
        return L.embed(params, tokens, cfg), positions

    # -- full sequence (scoring) -------------------------------------------------
    def forward(self, params: Params, batch: Batch):
        """Final hidden states [B, T, D] over whole sequences, and the
        auxiliary loss summed over layers (0 without MoE)."""
        cfg = self.cfg
        x, positions = self._inputs(params, batch)
        aux = 0.0
        for i in range(cfg.num_layers):
            x, a = decoder_layer_train(_layer(params["layers"], i), x, cfg,
                                       positions)
            aux = aux + a
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def logits(self, params: Params, batch: Batch) -> torch.Tensor:
        x, _ = self.forward(params, batch)
        return L.unembed(params, x, self.cfg)

    # -- dense serving -----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device) -> Params:
        cfg = self.cfg
        if cfg.rwkv:
            return _stack([W.init_rwkv_state(cfg, batch, L.dtype_of(cfg),
                                             device)] * cfg.num_layers)
        s = min(cache_len, cfg.window) if cfg.attention_kind == "local" \
            else cache_len
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, s, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
                "v": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)}

    def prefill(self, params: Params, batch: Batch, cache_len: int):
        """tokens [B, T] (or embeds and positions) -> (logits [B, V] after
        the last token, cache); an RWKV6 cache is the stacked state after
        the last token."""
        cfg = self.cfg
        x, positions = self._inputs(params, batch)
        caches = []
        for i in range(cfg.num_layers):
            x, kv = decoder_layer_prefill(_layer(params["layers"], i), x, cfg,
                                          positions, cache_len)
            caches.append(kv)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(params, x[:, -1:], cfg)[:, 0]
        return logits, _stack(caches)

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: int):
        """tokens: [B, 1] ids (embedded for every input kind, as in JAX);
        pos: absolute position (host int, unused by RWKV6; on all three
        axes under M-RoPE).  Returns (logits [B, V], cache updated in
        place)."""
        cfg = self.cfg
        x = L.embed(params, tokens, cfg)
        for i in range(cfg.num_layers):
            x, _ = decoder_layer_decode(_layer(params["layers"], i), x, cfg,
                                        _layer(cache, i), pos)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.unembed(params, x, cfg)[:, 0], cache

    # -- paged serving ----------------------------------------------------------
    @property
    def supports_paged(self) -> bool:
        """Paged KV is wired for the standard GQA decoder stack (dense or
        MoE FFN): token inputs, global attention, standard RoPE — the JAX
        package's rule, term for term."""
        cfg = self.cfg
        return (cfg.input_kind == "tokens" and not cfg.rwkv
                and cfg.attention_kind == "global" and not cfg.mrope)

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


class HybridLM:
    """RecurrentGemma: super-blocks of ``cfg.block_pattern`` temporal
    blocks (RG-LRU recurrent or local attention, each followed by an MLP),
    then ``cfg.tail_pattern``.  Served by the dense engine only."""

    def __init__(self, cfg: ModelConfig):
        if not cfg.block_pattern:
            raise ValueError(f"{cfg.name}: HybridLM needs a block_pattern")
        self.cfg = cfg
        self.n_super = (cfg.num_layers - len(cfg.tail_pattern)) \
            // len(cfg.block_pattern)

    # -- params ---------------------------------------------------------------
    def _init_block(self, init: L.Initializer, n, kind: str) -> Params:
        cfg = self.cfg
        sub = {"ln1": init.ones(n, cfg.d_model),
               "ln2": init.ones(n, cfg.d_model)}
        if kind == "rec":
            sub["rec"] = R.init_recurrent_block(init, n, cfg)
        else:
            sub["attn"] = init.attention(n, cfg)
        sub["mlp"] = init.mlp(n, cfg)
        return sub

    def init(self, seed: int, device: torch.device) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device``; ``lam`` is float32 as in the JAX init."""
        cfg = self.cfg
        init = L.Initializer(seed, device, L.dtype_of(cfg))
        p: Params = init.embedding(cfg)
        p["supers"] = {f"b{i}": self._init_block(init, self.n_super, kind)
                       for i, kind in enumerate(cfg.block_pattern)}
        p["tail"] = {f"t{i}": self._init_block(init, None, kind)
                     for i, kind in enumerate(cfg.tail_pattern)}
        p["final_norm"] = init.ones(None, cfg.d_model)
        return p

    def _blocks(self, params: Params, cache=None):
        """(sub-params, kind, cache slot) of every block in order: views
        into the stacked super-blocks, then the tail."""
        cfg = self.cfg
        for j in range(self.n_super):
            for i, kind in enumerate(cfg.block_pattern):
                c = None if cache is None \
                    else _layer(cache["supers"][f"b{i}"], j)
                yield _layer(params["supers"][f"b{i}"], j), kind, c
        for i, kind in enumerate(cfg.tail_pattern):
            c = None if cache is None else cache["tail"][f"t{i}"]
            yield params["tail"][f"t{i}"], kind, c

    # -- full sequence (scoring) -------------------------------------------------
    def _block_train(self, sub: Params, kind: str, x, positions):
        cfg = self.cfg
        h = L.rms_norm(x, sub["ln1"], cfg.norm_eps)
        if kind == "rec":
            y, _ = R.recurrent_block(sub["rec"], h, cfg)
        else:
            y = L.attention_train(sub["attn"], h, cfg, positions,
                                  window=cfg.window)
        x = x + y
        h = L.rms_norm(x, sub["ln2"], cfg.norm_eps)
        return x + L.mlp(sub["mlp"], h, cfg)

    def forward(self, params: Params, batch: Batch
                ) -> Tuple[torch.Tensor, float]:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed(params, tokens, cfg)
        positions = _positions(tokens)
        for sub, kind, _ in self._blocks(params):
            x = self._block_train(sub, kind, x, positions)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0

    def logits(self, params: Params, batch: Batch) -> torch.Tensor:
        x, _ = self.forward(params, batch)
        return L.unembed(params, x, self.cfg)

    # -- serving ---------------------------------------------------------------
    def _empty_block_cache(self, kind: str, batch: int, cache_len: int,
                           device):
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        if kind == "rec":
            return R.init_recurrent_state(cfg, batch, dt, device)
        s = min(cache_len, cfg.window or cache_len)
        shape = (batch, cfg.num_kv_heads, s, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def init_cache(self, batch: int, cache_len: int, device):
        cfg = self.cfg
        sup = {f"b{i}": _stack([self._empty_block_cache(kind, batch,
                                                        cache_len, device)]
                               * self.n_super)
               for i, kind in enumerate(cfg.block_pattern)}
        tail = {f"t{i}": self._empty_block_cache(kind, batch, cache_len,
                                                 device)
                for i, kind in enumerate(cfg.tail_pattern)}
        return {"supers": sup, "tail": tail}

    def _block_prefill(self, sub: Params, kind: str, x, positions,
                       cache_len: int):
        cfg = self.cfg
        h = L.rms_norm(x, sub["ln1"], cfg.norm_eps)
        if kind == "rec":
            y, new_cache = R.recurrent_block(sub["rec"], h, cfg)
        else:
            # the attention cache is min(cache_len, window) long, padded
            # only when the prompt is shorter: a prompt longer than the
            # window leaves a T-long cache that decodes unwindowed
            y, new_cache = L.attention_prefill(
                sub["attn"], h, cfg, positions,
                min(cache_len, cfg.window or cache_len), window=cfg.window)
        x = x + y
        h = L.rms_norm(x, sub["ln2"], cfg.norm_eps)
        return x + L.mlp(sub["mlp"], h, cfg), new_cache

    def prefill(self, params: Params, batch: Batch, cache_len: int):
        """tokens [B, T] -> (logits [B, V] after the last token, cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed(params, tokens, cfg)
        positions = _positions(tokens)
        per_block = []
        for sub, kind, _ in self._blocks(params):
            x, c = self._block_prefill(sub, kind, x, positions, cache_len)
            per_block.append(c)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(params, x[:, -1:], cfg)[:, 0]
        width = len(cfg.block_pattern)
        sup = {f"b{i}": _stack(per_block[i:self.n_super * width:width])
               for i in range(width)}
        tail = {f"t{i}": c
                for i, c in enumerate(per_block[self.n_super * width:])}
        return logits, {"supers": sup, "tail": tail}

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: int):
        """tokens: [B, 1]; pos: absolute position (host int).  Returns
        (logits [B, V], cache updated in place)."""
        cfg = self.cfg
        x = L.embed(params, tokens, cfg)
        for sub, kind, c in self._blocks(params, cache):
            h = L.rms_norm(x, sub["ln1"], cfg.norm_eps)
            if kind == "rec":
                y, new = R.recurrent_block(sub["rec"], h, cfg, state=c)
                for name, val in new.items():   # write through the view
                    c[name].copy_(val)
            else:
                y, _ = L.attention_decode(sub["attn"], h, cfg, c, pos,
                                          window=cfg.window)
            x = x + y
            h = L.rms_norm(x, sub["ln2"], cfg.norm_eps)
            x = x + L.mlp(sub["mlp"], h, cfg)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.unembed(params, x, cfg)[:, 0], cache


class EncDecLM:
    """Encoder-decoder LM (the Seamless backbone): a non-causal encoder
    over frame embeddings ``batch["frames"]`` [B, S, D], and a token
    decoder whose layers add cross-attention over the encoder's output
    (the memory).  Served by the dense engine only; the memory rides in
    the cache beside the decoder's K/V."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init(self, seed: int, device: torch.device) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device``."""
        cfg = self.cfg
        init = L.Initializer(seed, device, L.dtype_of(cfg))
        ne, nd, d = cfg.encoder_layers, cfg.num_layers, cfg.d_model
        p: Params = init.embedding(cfg)
        p["encoder"] = {"ln1": init.ones(ne, d), "ln2": init.ones(ne, d),
                        "attn": init.attention(ne, cfg),
                        "mlp": init.mlp(ne, cfg)}
        p["decoder"] = {"ln1": init.ones(nd, d), "ln_x": init.ones(nd, d),
                        "ln2": init.ones(nd, d),
                        "attn": init.attention(nd, cfg),
                        "xattn": init.cross_attention(nd, cfg),
                        "mlp": init.mlp(nd, cfg)}
        p["enc_norm"] = init.ones(None, d)
        p["final_norm"] = init.ones(None, d)
        return p

    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S, D] -> memory [B, S, D]: non-causal self-attention
        layers, then the encoder's final norm."""
        cfg = self.cfg
        x = frames.to(L.dtype_of(cfg))
        positions = _positions(x[..., 0])
        for i in range(cfg.encoder_layers):
            p = _layer(params["encoder"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + L.attention_train(p["attn"], h, cfg, positions,
                                      causal=False)
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + L.mlp(p["mlp"], h, cfg)
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _cross_mlp(self, p: Params, x: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
        """A decoder layer after its self-attention: cross-attention over
        the memory, then the MLP."""
        cfg = self.cfg
        h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + L.cross_attention(p["xattn"], h, memory, cfg)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg)

    def _decode_train(self, params: Params, tokens: torch.Tensor,
                      memory: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.embed(params, tokens, cfg)
        positions = _positions(tokens)
        for i in range(cfg.num_layers):
            p = _layer(params["decoder"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + L.attention_train(p["attn"], h, cfg, positions)
            x = self._cross_mlp(p, x, memory)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps)

    # -- full sequence (scoring) -------------------------------------------------
    def forward(self, params: Params, batch: Batch):
        """frames [B, S, D] and tokens [B, T] -> (final decoder states
        [B, T, D], aux loss 0)."""
        memory = self.encode(params, batch["frames"])
        return self._decode_train(params, batch["tokens"], memory), 0.0

    def logits(self, params: Params, batch: Batch) -> torch.Tensor:
        x, _ = self.forward(params, batch)
        return L.unembed(params, x, self.cfg)

    # -- dense serving -----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device) -> Params:
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len,
                 cfg.head_dim)
        mem_len = max(cache_len // cfg.frame_ratio, 1)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "memory": torch.zeros((batch, mem_len, cfg.d_model),
                                      dtype=dt, device=device)}

    def prefill(self, params: Params, batch: Batch, cache_len: int):
        """frames [B, S, D] and tokens [B, T] -> (logits [B, V] after the
        last token, {"k", "v", "memory"})."""
        cfg = self.cfg
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        x = L.embed(params, tokens, cfg)
        positions = _positions(tokens)
        caches = []
        for i in range(cfg.num_layers):
            p = _layer(params["decoder"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            att, kv = L.attention_prefill(p["attn"], h, cfg, positions,
                                          cache_len)
            x = self._cross_mlp(p, x + att, memory)
            caches.append(kv)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(params, x[:, -1:], cfg)[:, 0]
        return logits, {**_stack(caches), "memory": memory}

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    pos: int):
        """tokens: [B, 1]; pos: absolute position (host int).  Returns
        (logits [B, V], cache with its K/V updated in place)."""
        cfg = self.cfg
        x = L.embed(params, tokens, cfg)
        kv = {"k": cache["k"], "v": cache["v"]}
        for i in range(cfg.num_layers):
            p = _layer(params["decoder"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            att, _ = L.attention_decode(p["attn"], h, cfg, _layer(kv, i),
                                        pos)
            x = self._cross_mlp(p, x + att, cache["memory"])
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.unembed(params, x, cfg)[:, 0], cache


def get_model(cfg: ModelConfig):
    if cfg.encoder_layers:
        return EncDecLM(cfg)
    if cfg.block_pattern:
        return HybridLM(cfg)
    return DecoderLM(cfg)

"""Operations and bytes the benchmark's work needs, and the chip's peaks.

The benchmark's own arithmetic: what a roofline or a peak share divides
by.  Counts are of what the algorithm needs, from the shapes, with each
input byte read once and each output byte written once; whatever a kernel
reads again is its own cost.

What a model needs is counted by its family's ``counts(conf)``
(:func:`harness.family`), which the run record carries as ``counts``:
an object with ``weight_bytes()``, ``kv_bytes(ctx)``,
``decode_token_flops(ctx)``, ``prefill_token_flops()``,
``decode_attn_bytes(ctx)`` and ``train_step_flops(batch, seq)``; the Qwen2
decoder's is :class:`Model`.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Model:
    """The numbers of one configuration file that the counts need."""

    def __init__(self, conf: dict):
        self.layers = conf["num_hidden_layers"]
        self.d = conf["hidden_size"]
        self.heads = conf["num_attention_heads"]
        self.kv_heads = conf["num_key_value_heads"]
        self.hd = self.d // self.heads
        self.vocab = conf["vocab_size"]
        self.tied = bool(conf["tie_word_embeddings"])
        self.dtype = conf["torch_dtype"]
        self.bytes = BYTES[self.dtype]
        self.moe = "num_experts" in conf
        if self.moe:
            self.experts = conf["num_experts"]
            self.top_k = conf["num_experts_per_tok"]
            self.fe = conf["moe_intermediate_size"]
            self.fs = conf["shared_expert_intermediate_size"]
        else:
            self.ff = conf["intermediate_size"]

    # -- parameters ---------------------------------------------------------
    def attn_params(self) -> int:
        q, kv = self.heads * self.hd, self.kv_heads * self.hd
        return 2 * self.d * q + 2 * self.d * kv + q + 2 * kv

    def ffn_params(self) -> Tuple[int, int]:
        """(parameters every token uses, parameters of all experts)."""
        if not self.moe:
            n = 3 * self.d * self.ff
            return n, n
        per = 3 * self.d * self.fe
        shared = 3 * self.d * self.fs + self.d * self.experts
        return shared + self.top_k * per, shared + self.experts * per

    def matmul_params_per_token(self) -> int:
        """Parameters one token multiplies in the layers (no embedding)."""
        return self.layers * (self.attn_params() + self.ffn_params()[0])

    def weight_bytes(self) -> int:
        """All weights once: what a step reads at the least."""
        emb = self.vocab * self.d * (1 if self.tied else 2)
        per_layer = self.attn_params() + self.ffn_params()[1] + 2 * self.d
        router = self.layers * self.d * self.experts if self.moe else 0
        return self.bytes * (emb + self.layers * per_layer + self.d) \
            + router * 2   # the router is float32: 2 more bytes a weight

    # -- work ---------------------------------------------------------------
    def kv_bytes(self, ctx: int) -> int:
        """K and V of ``ctx`` positions in every layer."""
        return 2 * self.layers * self.kv_heads * self.hd * self.bytes * ctx

    def attn_flops(self, ctx: int) -> int:
        """One query against ``ctx`` keys in every layer: QK and PV."""
        return 4 * self.layers * self.heads * self.hd * ctx

    def decode_token_flops(self, ctx: int) -> int:
        """One generated token at context ``ctx`` (keys, itself included):
        the layers, the attention and its row of logits."""
        return 2 * self.matmul_params_per_token() + self.attn_flops(ctx) \
            + 2 * self.d * self.vocab

    def prefill_token_flops(self) -> int:
        """A prompt token's products in the layers, its attention left
        out (a lower bound: where each reused prefix ends is not seen)."""
        return 2 * self.matmul_params_per_token()

    def decode_attn_bytes(self, ctx: int) -> int:
        """One decode row through the decode kernel in every layer: its
        query and output once, K and V of ``ctx`` positions once."""
        qo = 2 * self.heads * self.hd * self.bytes * self.layers
        return qo + self.kv_bytes(ctx)

    def train_step_flops(self, batch: int, seq: int) -> int:
        """Forward and backward of one training step: 6 FLOPs a parameter
        a token, the logits included, plus causal attention (half the
        square) at 3 times its forward."""
        params = self.matmul_params_per_token() + self.d * self.vocab
        attn = 3 * 4 * self.layers * self.heads * self.hd \
            * (seq * (seq + 1) // 2)
        return batch * (6 * params * seq + attn)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip needs for the work: the larger bound."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


STEP_GAP_S = 0.005   # tokens of one step are stamped closer than this


def row_steps(emits: Iterable[float], gap_s: float) -> list:
    """Indices of the tokens that open a row-step: tokens of one request
    stamped within ``gap_s`` of the one before came out of one step."""
    out, prev = [], None
    for i, t in enumerate(emits):
        if prev is None or t - prev > gap_s:
            out.append(i)
        prev = t
    return out


def serve_step_mfu(rec) -> float:
    """A serving window's least time on the chip over its wall time, in
    %: the FLOPs of its generated and prefilled tokens, or the bytes of
    its steps' weights and its decoding rows' K/V, whichever bounds."""
    m = rec["counts"]
    lo, hi = rec["open"], rec["close"]
    flops = nbytes = 0
    prefill = 0
    for r in rec["server_requests"]:
        t, emits = r["plen"], r["emits"]
        if emits and lo <= emits[0] < hi:
            prefill += t
        for i, e in enumerate(emits):
            if lo <= e < hi:
                flops += m.decode_token_flops(t + i + 1)
        # a decoding row reads its K/V once a step, however many of its
        # tokens (verified drafts) the step emits
        for i in row_steps(emits, STEP_GAP_S):
            if lo <= emits[i] < hi:
                nbytes += m.kv_bytes(t + i + 1)
    s0, s1 = rec["stats0"], rec["stats1"]
    reused = s1["prefix_tokens_reused"] - s0["prefix_tokens_reused"]
    flops += max(0, prefill - reused) * m.prefill_token_flops()
    steps = max(s1["mixed_steps"] - s0["mixed_steps"],
                s1["decode_steps"] - s0["decode_steps"])
    nbytes += steps * m.weight_bytes()
    return 100.0 * bound_s(flops, nbytes, rec["conf"]["torch_dtype"]) \
        / rec["window_s"]


def decode_kernel_bytes(rec, start: float, stop: float) -> int:
    """Bytes the plain decode steps stamped in ``[start, stop)`` need
    from the decode kernel (see ``metrics/paged_attn_roofline.tput``)."""
    m = rec["counts"]
    reqs = rec["server_requests"]
    stamps = sorted((e, k, i) for k, r in enumerate(reqs)
                    for i, e in enumerate(r["emits"]))
    bursts, cur = [], []
    for s in stamps:
        if cur and s[0] - cur[-1][0] > STEP_GAP_S:
            bursts.append(cur)
            cur = []
        cur.append(s)
    if cur:
        bursts.append(cur)
    total = 0
    for b in range(1, len(bursts)):
        began, ended = bursts[b - 1][-1][0], bursts[b][0][0]
        if not start <= ended < stop:
            continue
        mixed = any(r["submit"] < began and
                    (not r["emits"] or r["emits"][0] > ended) for r in reqs)
        if not mixed:
            total += sum(m.decode_attn_bytes(reqs[k]["plen"] + i + 1)
                         for _, k, i in bursts[b])
    return total

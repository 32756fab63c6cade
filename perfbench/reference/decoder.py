"""Plain PyTorch reference of the served decoders, in float32.

What the benchmark compares the program's served tokens with.  It reads
the configuration file's numbers (``Arch``), the weights the benchmark
made from the seed, and the token ids the benchmark sent and got back;
it imports nothing of the program.  Every matrix product runs in float32
with TF32 off (:func:`strict_float32`).

The model is the Qwen2 decoder as the port runs it (``port_departures``
in the configuration file): RMSNorm, GQA with QKV biases and rotary
embeddings on the half-split layout, SwiGLU; the tied embedding scaled
by ``sqrt(d_model)`` rounded to the model's dtype.  The MoE layer routes
by a float32 softmax over the experts, keeps the top ``k`` (weights
renormalised over them), adds the ungated shared experts, and drops the
tokens that overflow an expert's capacity inside a dispatch group.

``quant="fp8"`` is the control: the same computation with every weight
matrix and every matrix product's input rounded to float8 e4m3 (a scale
per output channel, and per token), the precision below the served
bfloat16.

It runs layer by layer over all the requests of a sample: each layer's
weights are widened to float32 once, so that it fits beside the served
weights of the largest model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Q_BLOCK = 1024       # query rows a block of the attention scores holds
FP8_MAX = 448.0      # largest finite float8 e4m3


@dataclasses.dataclass(frozen=True)
class Arch:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    tied: bool
    qkv_bias: bool
    dtype: str
    experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    shared: int = 0
    capacity_factor: float = 0.0

    @classmethod
    def from_config(cls, conf: dict) -> "Arch":
        """From a configuration file (Hugging Face keys)."""
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        moe = "num_experts" in conf
        return cls(
            layers=conf["num_hidden_layers"], d_model=d, heads=h,
            kv_heads=conf["num_key_value_heads"],
            head_dim=conf.get("head_dim", d // h),
            d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
            rope_theta=float(conf["rope_theta"]),
            norm_eps=float(conf["rms_norm_eps"]),
            tied=bool(conf["tie_word_embeddings"]),
            qkv_bias=bool(conf["qkv_bias"]),
            dtype=conf["torch_dtype"],
            experts=conf.get("num_experts", 0),
            top_k=conf.get("num_experts_per_tok", 0),
            d_expert=conf.get("moe_intermediate_size", 0),
            shared=(conf["shared_expert_intermediate_size"]
                    // conf["moe_intermediate_size"]) if moe else 0,
            capacity_factor=float(conf.get("capacity_factor", 0.0)))

    def moe_free(self) -> bool:
        return self.experts == 0

    def capacity(self, width: int) -> int:
        """Slots an expert has in a dispatch group ``width`` tokens wide
        (Python's ``round``: halves to even)."""
        return int(max(1, round(width * self.top_k * self.capacity_factor
                                / self.experts)))


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale per slice along ``dim``
    (absmax over the other dims mapped to the format's largest value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Mat:
    """Matrix products in float32, or in the fp8 control."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.quant = quant

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight ``[..., d_in, d_out]`` widened to float32 (and rounded
        per output column in the control)."""
        t = t.float()
        return _fp8(t, dim=-2) if self.quant else t

    def x(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t, dim=-1) if self.quant else t


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding at positions 0..T-1 on the half-split layout.
    x: [H, T, hd]."""
    hd, t = x.shape[-1], x.shape[-2]
    half = hd // 2
    freqs = float(theta) ** (-torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal GQA over one sequence in query blocks.  q: [Hq, T, hd];
    k, v: [Hkv, T, hd].  Returns [T, Hq * hd]."""
    hq, t, hd = q.shape
    g = hq // k.shape[0]
    k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    out = torch.empty_like(q)
    for lo in range(0, t, Q_BLOCK):
        hi = min(lo + Q_BLOCK, t)
        s = q[:, lo:hi] @ k[:, :hi].transpose(1, 2) / math.sqrt(hd)
        mask = torch.arange(hi, device=q.device)[None, :] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, lo:hi] = torch.softmax(s, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1).reshape(t, hq * hd)


def _keep(idx: torch.Tensor, groups: Sequence[Tuple[int, int, int]],
          arch: Arch) -> torch.Tensor:
    """Which (token, slot) routes survive the capacity of their group.
    idx: [T, k] expert ids.  ``groups`` are (start, end, width): the
    tokens ``start:end`` of one dispatch group ``width`` wide, in the
    order the dispatch counts them (token-major, slot-minor)."""
    keep = torch.ones_like(idx, dtype=torch.bool)
    for lo, hi, width in groups:
        cap = arch.capacity(width)
        flat = idx[lo:hi].reshape(-1)
        onehot = F.one_hot(flat, arch.experts)
        pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
        keep[lo:hi] = (pos < cap).view(hi - lo, -1)
    return keep


def moe(p: dict, h: torch.Tensor, groups, arch: Arch, mat: _Mat):
    """The MoE FFN of one sequence's normed states h [T, D]."""
    logits = h @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, arch.top_k, dim=-1, sorted=True)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    w = w * _keep(idx, groups, arch)
    out = torch.zeros_like(h)
    hx = mat.x(h)
    for e in range(arch.experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = hx[tok]
        y = (F.silu(x @ mat.w(p["w_gate"][e])) * (x @ mat.w(p["w_up"][e])))
        y = mat.x(y) @ mat.w(p["w_down"][e])
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    if arch.shared:
        sp = p["shared"]
        y = F.silu(hx @ mat.w(sp["w_gate"])) * (hx @ mat.w(sp["w_up"]))
        out = out + mat.x(y) @ mat.w(sp["w_down"])
    return out


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _embed_scale(arch: Arch) -> float:
    dt = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}[arch.dtype]
    return float(torch.tensor(arch.d_model ** 0.5, dtype=dt))


@torch.no_grad()
def logits_at(params: dict, arch: Arch, seqs: List[torch.Tensor],
              at: List[torch.Tensor], groups: List[list] = None,
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """float32 logits ``[len(at[i]), V]`` of each sequence at the
    positions ``at[i]`` (the logits after the token at each position).
    ``groups[i]`` are sequence i's MoE dispatch groups (see
    :func:`_keep`); tokens outside every group are never dropped."""
    mat = _Mat(quant)
    groups = groups or [[] for _ in seqs]
    emb = params["embed"]
    xs = []
    for s in seqs:
        x = emb[s].float()
        if arch.tied:
            x = x * _embed_scale(arch)
        xs.append(x)
    for i in range(arch.layers):
        p = _layer(params["layers"], i)
        a = p["attn"]
        wq, wk, wv, wo = (mat.w(a[n]) for n in ("wq", "wk", "wv", "wo"))
        if arch.moe_free():
            mp = {n: mat.w(p["mlp"][n]) for n in ("w_gate", "w_up",
                                                  "w_down")}
        for j, x in enumerate(xs):
            t = x.shape[0]
            h = mat.x(rms_norm(x, p["ln1"], arch.norm_eps))
            q, k, v = h @ wq, h @ wk, h @ wv
            if arch.qkv_bias:
                q, k, v = q + a["bq"].float(), k + a["bk"].float(), \
                    v + a["bv"].float()
            q = rope(q.view(t, arch.heads, -1).transpose(0, 1),
                     arch.rope_theta)
            k = rope(k.view(t, arch.kv_heads, -1).transpose(0, 1),
                     arch.rope_theta)
            v = v.view(t, arch.kv_heads, -1).transpose(0, 1)
            x = x + mat.x(attention(q, k, v)) @ wo
            h = rms_norm(x, p["ln2"], arch.norm_eps)
            if arch.moe_free():
                hx = mat.x(h)
                y = F.silu(hx @ mp["w_gate"]) * (hx @ mp["w_up"])
                x = x + mat.x(y) @ mp["w_down"]
            else:
                x = x + moe(p["moe"], h, groups[j], arch, mat)
            xs[j] = x
        del wq, wk, wv, wo
    head = emb.t() if arch.tied else params["lm_head"]
    out = []
    for x, pos in zip(xs, at):
        h = mat.x(rms_norm(x[pos], params["final_norm"], arch.norm_eps))
        out.append(h @ mat.w(head))
    return out

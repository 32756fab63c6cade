"""Model configuration dataclasses + the --arch registry.

A copy of the JAX package's ``configs/base.py``, field for field, so a
config built on either side describes the same model.  One default
differs: :attr:`ModelConfig.attention_impl`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0          # always-on shared experts (qwen2-moe: 4)
    d_expert: int = 0            # per-expert FFN width
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's hyperparameters.

    ``attention_impl`` selects how every kernel on the model path runs
    (paged attention, flash attention, the RG-LRU scan and the WKV scan):
    ``"kernel"`` (the default here) launches the hand-written CUDA kernel
    for CUDA tensors and uses its plain PyTorch version for CPU tensors;
    ``"reference"`` calls the plain version by name on any device.  This
    departs from the JAX package in two ways: its default is
    ``"reference"``, so its models reach their Pallas kernels only when
    asked, where in the port the kernel is the default on the card; and
    its recurrent blocks call the RG-LRU and WKV scans with no impl,
    where the port passes this field, so that ``"reference"`` selects the
    plain version of every kernel on the path.
    """

    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer details
    mlp_act: str = "swiglu"      # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    # attention behaviour
    attention_kind: str = "global"      # global | local | none
    window: Optional[int] = None        # local attention window
    mrope: bool = False                 # qwen2-vl M-RoPE (3 position axes)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    # MoE
    moe: Optional[MoEConfig] = None
    moe_dispatch: str = "grouped"   # grouped (GShard rows) | global (§Perf)
    # hybrid (recurrentgemma): super-block pattern + tail
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    tail_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None
    conv_width: int = 4
    # rwkv6
    rwkv: bool = False
    rwkv_head_dim: int = 64
    time_mix_extra_dim: int = 32
    decay_extra_dim: int = 64
    rwkv_impl: str = "sequential"   # sequential | chunked (§Perf)
    rwkv_chunk: int = 32
    # encoder-decoder
    encoder_layers: int = 0
    frame_ratio: int = 8         # audio frames per text token (stub frontend)
    # modality frontend stub
    input_kind: str = "tokens"   # tokens | embeddings | frames
    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "none"          # none | full
    attention_impl: str = "kernel"   # kernel | reference
    loss_chunk: int = 0          # 0 = unchunked vocab loss
    attention_q_chunk: int = 256
    attention_chunk_threshold: int = 4096
    fsdp_per_layer_gather: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            # time-mix (r,k,v,w,g + output) + channel-mix + loras + norms
            att = d * self.q_dim * 4 + d * d + 6 * d
            lora = 5 * (d * self.time_mix_extra_dim * 2) \
                + d * self.decay_extra_dim * 2
            ffn = 2 * d * f + d * d
            return emb + L * (att + lora + ffn)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe is not None:
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_expert
            shared = m.num_shared * 3 * d * m.d_expert
            router = d * m.num_experts
            ffn = routed + shared + router
        else:
            n_mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            ffn = n_mats * d * f
        layers = L * (attn + ffn)
        if self.encoder_layers:
            layers += self.encoder_layers * (attn + 3 * d * f) \
                + self.num_layers * attn  # cross-attention
        if self.block_pattern:
            # hybrid: recurrent blocks replace attention in pattern ratio
            rec = 2 * d * (self.lru_width or d) + 3 * (self.lru_width or d) \
                + (self.lru_width or d) * self.conv_width
            n_rec = sum(1 for b in self.block_pattern if b == "rec")
            n_attn = len(self.block_pattern) - n_rec
            per_super = n_rec * (rec + ffn) + n_attn * (attn + ffn)
            n_super = self.num_layers // len(self.block_pattern)
            tail = sum((rec if b == "rec" else attn) + ffn
                       for b in self.tail_pattern)
            layers = n_super * per_super + tail
        return emb + layers

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k count)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        m = self.moe
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        active_ffn = (m.top_k + m.num_shared) * 3 * d * m.d_expert \
            + d * m.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + active_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from . import load_all  # late import populates registry
        load_all()
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    from . import load_all
    load_all()
    return dict(_REGISTRY)


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (ssm / hybrid)."""
    return cfg.family in ("ssm", "hybrid")


def has_decoder(cfg: ModelConfig) -> bool:
    return True  # every assigned arch has a decode path (enc-dec included)


def cells_for(cfg: ModelConfig):
    """The (arch x shape) dry-run cells this arch participates in."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not supports_long_context(cfg):
            continue
        out.append(s)
    return out


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", remat="none",
        loss_chunk=0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2,
                              num_shared=min(cfg.moe.num_shared, 1),
                              d_expert=32)
    if cfg.block_pattern:
        kw["block_pattern"] = cfg.block_pattern
        kw["tail_pattern"] = cfg.tail_pattern
        kw["num_layers"] = 2 * len(cfg.block_pattern) + len(cfg.tail_pattern)
        kw["lru_width"] = 64
        kw["window"] = 8
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.rwkv:
        kw["rwkv_head_dim"] = 16
        kw["time_mix_extra_dim"] = 8
        kw["decay_extra_dim"] = 8
    if cfg.mrope:
        kw["mrope_sections"] = (2, 3, 3)  # sums to head_dim(16)//2
    if cfg.window is not None and not cfg.block_pattern:
        kw["window"] = 8
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)

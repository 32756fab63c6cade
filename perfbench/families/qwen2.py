"""The Qwen2 decoder (``model_type`` ``qwen2``), dense or with sparse
experts: GQA with QKV biases and rotary embeddings, RMSNorm, SwiGLU, and
in the MoE variant a softmax-routed top-k of uniform experts with shared
experts in every layer.  A family module as :func:`harness.family`
describes; :mod:`families.qwen2_moe` hands on these four functions.
"""
from __future__ import annotations

import dataclasses
from typing import List

import roofline as R
import weights as WT
from reference import compare as C
from reference.decoder import Arch


def port_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file: the registry
    entry named by ``arch`` gives the family and the paths; every size the
    file states (depth, widths, heads, vocabulary, RoPE base, norm epsilon,
    dtype, experts and their capacity) is the file's."""
    from repro_torch.configs import get_config
    cfg = get_config(conf["arch"])
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    sizes = dict(num_layers=conf["num_hidden_layers"], d_model=d,
                 num_heads=h, num_kv_heads=conf["num_key_value_heads"],
                 head_dim=d // h, vocab_size=conf["vocab_size"],
                 tie_embeddings=bool(conf["tie_word_embeddings"]),
                 qkv_bias=bool(conf["qkv_bias"]),
                 rope_theta=float(conf["rope_theta"]),
                 norm_eps=float(conf["rms_norm_eps"]),
                 dtype=conf["torch_dtype"])
    if "num_experts" in conf:
        fe = conf["moe_intermediate_size"]
        sizes["d_ff"] = fe
        sizes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=conf["num_experts"],
            top_k=conf["num_experts_per_tok"], d_expert=fe,
            num_shared=conf["shared_expert_intermediate_size"] // fe,
            capacity_factor=float(conf["capacity_factor"]))
    else:
        sizes["d_ff"] = conf["intermediate_size"]
    return dataclasses.replace(cfg, **sizes)


def leaf_specs(cfg) -> List[WT.Spec]:
    """Every leaf of a dense or MoE ``DecoderLM``'s parameter tree: the
    keys, shapes and dtypes ``DecoderLM.init`` builds (the MoE router
    float32, everything else the model's dtype)."""
    d, n, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    gain = WT.RESIDUAL_GAIN
    out: List[WT.Spec] = [(("embed",), (v, d), "model", ("normal", 0.02))]
    if not cfg.tie_embeddings:
        out.append((("lm_head",), (d, v), "model", ("dense", d)))
    lay = ("layers",)
    out += [(lay + ("ln1",), (n, d), "model", ("scale", 0.0)),
            (lay + ("ln2",), (n, d), "model", ("scale", 0.0)),
            (lay + ("attn", "wq"), (n, d, q), "model", ("dense", d)),
            (lay + ("attn", "wk"), (n, d, kv), "model", ("dense", d)),
            (lay + ("attn", "wv"), (n, d, kv), "model", ("dense", d)),
            (lay + ("attn", "wo"), (n, q, d), "model", ("wide", (q, gain)))]
    if cfg.qkv_bias:
        out += [(lay + ("attn", "bq"), (n, q), "model", ("normal", 0.02)),
                (lay + ("attn", "bk"), (n, kv), "model", ("normal", 0.02)),
                (lay + ("attn", "bv"), (n, kv), "model", ("normal", 0.02))]
    if cfg.moe is None:
        f = cfg.d_ff
        out += [(lay + ("mlp", "w_gate"), (n, d, f), "model", ("dense", d)),
                (lay + ("mlp", "w_up"), (n, d, f), "model", ("dense", d)),
                (lay + ("mlp", "w_down"), (n, f, d), "model",
                 ("wide", (f, gain)))]
    else:
        m = cfg.moe
        e, fe = m.num_experts, m.d_expert
        moe = lay + ("moe",)
        out += [(moe + ("router",), (n, d, e), "float32",
                 ("wide", (d, WT.ROUTER_GAIN))),
                (moe + ("w_gate",), (n, e, d, fe), "model", ("dense", d)),
                (moe + ("w_up",), (n, e, d, fe), "model", ("dense", d)),
                (moe + ("w_down",), (n, e, fe, d), "model",
                 ("wide", (fe, gain)))]
        if m.num_shared:
            fs = fe * m.num_shared
            sh = moe + ("shared",)
            out += [(sh + ("w_gate",), (n, d, fs), "model", ("dense", d)),
                    (sh + ("w_up",), (n, d, fs), "model", ("dense", d)),
                    (sh + ("w_down",), (n, fs, d), "model",
                     ("wide", (fs, gain)))]
    out.append((("final_norm",), (d,), "model", ("scale", 0.0)))
    return out


def readings(params: dict, conf: dict, server: dict, sample: List[dict], *,
             control: bool, device) -> dict:
    """The served tokens of ``sample`` judged by the plain Qwen2 decoder
    (:mod:`reference.decoder`); an MoE model's dispatch groups are the
    server's prefill chunks."""
    arch = Arch.from_config(conf)
    chunk = None if arch.moe_free() else server["prefill_chunk"]
    return C.served_gap(params, arch, sample, chunk=chunk, control=control,
                        device=device)


def counts(conf: dict) -> R.Model:
    """The Qwen2 decoder's operations and bytes."""
    return R.Model(conf)

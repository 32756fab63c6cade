"""Looking up the model by its family (``families/<model_type>.py``)
moves nothing: at the tiny dense and MoE sizes the same weights bit for
bit and the same readings over one fixed sample, and at the two real
configuration files the same roofline counts, as the harness gave before
the lookup (the values pinned here)."""
import hashlib
import json

import pytest
import torch

import harness as H
import perfbench_tiny as TINY
import weights as WT

SEED = 2 ** 33 + 1
SIZES = {"qwen2-1.5b": TINY.DENSE, "qwen2-moe-a2.7b": TINY.MOE}

# sha256 over every leaf's path, dtype, shape and bytes, in path order
WEIGHTS = {
    ("qwen2-1.5b", "float32"):
        "8341fd2622d146d2eff229afe89ee0e6818c98f797fc2551bfb8fb3dacf8f247",
    ("qwen2-1.5b", "bfloat16"):
        "78520f5905a7005d8492a2e0f38909e10fa60ac74af624c756d94d9ea5e3aafc",
    ("qwen2-moe-a2.7b", "float32"):
        "2fb23e6cf3606825e554e5aec8b9ca6a8ef9185a758d6449d4faa6a776db7e9f",
    ("qwen2-moe-a2.7b", "bfloat16"):
        "644e18b420794c4ac614c98a841dd419a6b3c7abdc1e244d12760e75060fd575",
}

# readings over SAMPLE at float32, the program's tokens and the control's
READINGS = {
    ("qwen2-1.5b", False): {
        "served_gap": 0.8147140741348267, "served_mismatch": 1.0,
        "served_mean_gap": 0.5453486693532843,
        "served_worst_mean_gap": 0.5812584161758423, "tokens": 19},
    ("qwen2-1.5b", True): {
        "served_gap": 0.03409022092819214,
        "served_mismatch": 0.2631578947368421,
        "served_mean_gap": 0.006034923227209794,
        "served_worst_mean_gap": 0.015168756246566772, "tokens": 19},
    ("qwen2-moe-a2.7b", False): {
        "served_gap": 4.624870777130127, "served_mismatch": 1.0,
        "served_mean_gap": 3.083295520983244,
        "served_worst_mean_gap": 3.3312811851501465, "tokens": 19},
    ("qwen2-moe-a2.7b", True): {
        "served_gap": 0.3733634948730469,
        "served_mismatch": 0.21052631578947367,
        "served_mean_gap": 0.03279110005027369,
        "served_worst_mean_gap": 0.047358617186546326, "tokens": 19},
}

# weight_bytes, kv_bytes(1024), decode_token_flops(1024),
# prefill_token_flops, decode_attn_bytes(1024), train_step_flops(8, 512)
COUNTS = {
    "qwen2-1.5b": [3_087_428_608, 29_360_128, 3_263_414_272, 2_620_506_112,
                   29_532_160, 38_478_393_901_056],
    "qwen2-moe-a2.7b": [28_637_368_320, 201_326_592, 4_957_044_736,
                        4_133_388_288, 201_523_200, 59_057_947_803_648],
}


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(tree)):
        h.update(repr((path, str(leaf.dtype), tuple(leaf.shape))).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _params(name, dtype):
    conf = TINY._conf(name, SIZES[name], dtype)
    fam = H.family(conf)
    cfg = fam.port_config(conf)
    return conf, fam, WT.make(cfg, SEED, "cpu", getattr(torch, dtype),
                              fam.leaf_specs(cfg))


def sample(vocab: int):
    """Three requests of fixed prompts and served tokens, drawn once."""
    g = torch.Generator().manual_seed(7)
    out = []
    for plen, slen in ((37, 9), (20, 6), (50, 4)):
        toks = torch.randint(0, vocab, (plen + slen,), generator=g).tolist()
        out.append({"prompt": toks[:plen], "served": toks[plen:]})
    return out


@pytest.mark.parametrize("name,dtype", sorted(WEIGHTS))
def test_weights_bit_for_bit(name, dtype):
    _, _, params = _params(name, dtype)
    assert digest(params) == WEIGHTS[name, dtype]


@pytest.mark.parametrize("name,control", sorted(READINGS))
def test_readings_over_a_fixed_sample(name, control):
    """The MoE model's prompts span 3 and 4 dispatch groups of 16."""
    conf, fam, params = _params(name, "float32")
    got = fam.readings(params, conf, {"prefill_chunk": 16},
                       sample(conf["vocab_size"]), control=control,
                       device="cpu")
    want = READINGS[name, control]
    assert set(got) == set(want) and got["tokens"] == want["tokens"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_of_the_real_configurations(name):
    conf = json.loads((H.HERE / "configs" / f"{name}.json").read_text())
    m = H.family(conf).counts(conf)
    assert [m.weight_bytes(), m.kv_bytes(1024), m.decode_token_flops(1024),
            m.prefill_token_flops(), m.decode_attn_bytes(1024),
            m.train_step_flops(8, 512)] == COUNTS[name]

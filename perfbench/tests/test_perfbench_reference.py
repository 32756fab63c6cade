"""The plain reference agrees with the port at a tiny size on the CPU,
in float32: the whole-sequence logits of the dense and the MoE decoder,
and the MoE layer's capacity drops inside a dispatch group."""
import dataclasses

import pytest
import torch

import perfbench_tiny as TINY
import serving
import weights as WT
from reference import compare as C
from reference import decoder as D


def _pair(name, sizes):
    conf = TINY._conf(name, sizes, "float32")
    cfg = dataclasses.replace(serving.model_config(conf),
                              attention_impl="reference")
    return conf, cfg, WT.make(cfg, 2 ** 33 + 1, "cpu", torch.float32)


@pytest.mark.parametrize("name,sizes", [("qwen2-1.5b", TINY.DENSE),
                                        ("qwen2-moe-a2.7b", TINY.MOE)])
def test_whole_sequence_logits(name, sizes):
    from repro_torch.models import get_model
    conf, cfg, params = _pair(name, sizes)
    toks = torch.randint(0, conf["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(3))
    want = get_model(cfg).logits(params, {"tokens": toks})[0]
    arch = D.Arch.from_config(conf)
    D.strict_float32()
    # the port's whole-sequence MoE call is one dispatch group 40 wide
    groups = [[] if arch.moe_free() else [(0, 40, 40)]]
    got = D.logits_at(params, arch, [toks[0]], [torch.arange(40)], groups)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_capacity_drops_matter_and_follow_the_port():
    from repro_torch.models import moe as M
    conf, cfg, params = _pair("qwen2-moe-a2.7b", TINY.MOE)
    arch = D.Arch.from_config(conf)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()
         if k != "shared"}
    p["shared"] = {k: v[0] for k, v in
                   params["layers"]["moe"]["shared"].items()}
    h = torch.randn(1, 24, conf["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    want, _ = M.moe_ffn_grouped(p, h, cfg)
    got = D.moe(p, h[0], [(0, 24, 24)], arch, D._Mat(None))
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)
    free = D.moe(p, h[0], [], arch, D._Mat(None))
    assert (free - want[0]).abs().max() > 1e-3, "no token was dropped"


def test_control_moves_the_logits():
    conf, cfg, params = _pair("qwen2-1.5b", TINY.DENSE)
    arch = D.Arch.from_config(conf)
    seq = torch.randint(0, 512, (30,), generator=torch.Generator()
                        .manual_seed(5))
    at = torch.arange(20, 29)
    full = D.logits_at(params, arch, [seq], [at])[0]
    low = D.logits_at(params, arch, [seq], [at], quant="fp8")[0]
    assert 1e-3 < (full - low).abs().max() < 1.0
    served = full.argmax(-1)
    assert C.widest_gap([full], [served]) == 0.0
    assert C.widest_gap([full], [(served + 1) % 512]) > 0.0


def test_gap_readings_by_hand():
    """Two requests of two positions each; the second request's tokens
    lie 1 and 3 below the best: the widest gap 3, the mean over all four
    positions 1, the worst request's mean 2, half the tokens not first."""
    ref = [torch.tensor([[0.0, 2.0], [5.0, 1.0]]),
           torch.tensor([[4.0, 3.0], [0.0, 3.0]])]
    toks = [torch.tensor([1, 0]), torch.tensor([1, 0])]
    assert C.widest_gap(ref, toks) == 3.0
    assert C.mean_gap(ref, toks) == 1.0
    assert C.worst_mean_gap(ref, toks) == 2.0
    assert C.mismatch_share(ref, toks) == 0.5

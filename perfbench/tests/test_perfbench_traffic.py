"""The generator: the same seed gives the same traffic, and every seed
the same amount of work."""
import collections
import json
from pathlib import Path

import numpy as np
import pytest

import traffic as TR

HERE = Path(__file__).resolve().parents[1]
CHAT = json.loads((HERE / "traffic" / "chat-sessions.json").read_text())
HEAVY = json.loads((HERE / "traffic" / "decode-heavy.json").read_text())
BIG = 2 ** 31 + 12345


def _sizes(plan):
    return sorted((s.system, tuple((t.user, t.reply, round(t.think_s, 9))
                                   for t in s.turns)) for s in plan)


def test_sessions_repeat_for_a_seed_and_keep_their_sizes():
    a = TR.session_plan(CHAT, BIG, 30.0, 2.0)
    b = TR.session_plan(CHAT, BIG, 30.0, 2.0)
    c = TR.session_plan(CHAT, 7, 30.0, 2.0)
    assert a == b
    assert a != c
    assert _sizes(a) == _sizes(c)
    assert [s.arrival_s for s in a] == [s.arrival_s for s in c]
    v = 151936
    assert np.array_equal(TR.user_tokens(BIG, 3, 1, 50, v),
                          TR.user_tokens(BIG, 3, 1, 50, v))
    assert [p.tolist() for p in TR.system_prompts(CHAT, BIG, v)] == \
        [p.tolist() for p in TR.system_prompts(CHAT, BIG, v)]


def test_sessions_stay_within_the_context_and_few_widths():
    plan = TR.session_plan(CHAT, 1, 60.0, 4.0)
    widths = {CHAT["system_prompts"]["length"]}
    for s in plan:
        ctx = CHAT["system_prompts"]["length"]
        for t in s.turns:
            widths.add(ctx + t.user)
            assert (ctx + t.user) % CHAT["prompt_grid"] == 0
            ctx += t.user + t.reply
            assert ctx <= CHAT["context_cap"]
    assert len(widths) <= 64


def test_closed_plan_same_work_every_seed():
    a, b = TR.closed_plan(HEAVY, BIG), TR.closed_plan(HEAVY, 3)
    assert a == TR.closed_plan(HEAVY, BIG)
    key = lambda p: sorted(tuple((r.prompt, r.new) for r in c) for c in p)
    assert key(a) == key(b)
    prompts = {r.prompt for c in a for r in c}
    assert len(prompts) <= 64
    assert all(HEAVY["prompt_tokens"]["min"] <= p <=
               HEAVY["prompt_tokens"]["max"] for p in prompts)


@pytest.mark.parametrize("spec", [{"median": 96, "sigma": 0.8, "min": 16,
                                   "max": 1024}])
def test_lognormal_median_and_clip(spec):
    x = TR.lognormal_ints(TR.rng(0, 1), spec, 20000)
    assert x.min() >= 16 and x.max() <= 1024
    assert abs(np.median(x) - 96) <= 3


def test_seed_past_32_bits_and_negative():
    assert TR.rng(2 ** 40, 1).integers(0, 1 << 30) == \
        TR.rng(2 ** 40, 1).integers(0, 1 << 30)
    TR.rng(-5, 2).integers(0, 10)


def test_turn_counts_spread():
    plan = TR.session_sizes(CHAT, 400, 100.0, CHAT["plan_seed"])
    counts = collections.Counter(len(s.turns) for s in plan)
    assert set(counts) <= set(range(0, 7)) and len(counts) >= 5

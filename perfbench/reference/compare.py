"""The comparison that decides a serving cell's ``correct``.

For each sampled request the reference runs once over its prompt and the
tokens the server returned (teacher forcing) and reads, at every served
position, how far the served token's logit lies below the reference's
best there; the cell's limits file says which of the readings (the
widest gap, the mean gap) it compares.  Valid for greedy tokens only:
every served mix here is greedy.

The control, put in the program's place, is judged the same way: the
token that the fp8 control (:mod:`.decoder`'s ``quant="fp8"``) puts first
at each position stands for the served one.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from . import decoder as D


def _inputs(sample: List[dict], device):
    seqs, at, served = [], [], []
    for r in sample:
        p, s = r["prompt"], r["served"]
        seqs.append(torch.tensor(p + s, dtype=torch.long, device=device))
        at.append(torch.arange(len(p) - 1, len(p) + len(s) - 1,
                               device=device))
        served.append(torch.tensor(s, dtype=torch.long, device=device))
    return seqs, at, served


def dispatch_groups(sample: List[dict], arch: D.Arch,
                    chunk: Optional[int]) -> List[list]:
    """Each request's MoE dispatch groups as the server formed them: the
    prompt prefilled in ``chunk``-token pieces from position 0, each a
    group ``chunk`` wide (padding counted, real tokens first); every
    decoded token is a group of its own and never overflows.  Dense
    models and ``chunk`` None: no groups."""
    if arch.moe_free() or not chunk:
        return [[] for _ in sample]
    out = []
    for r in sample:
        t = len(r["prompt"])
        out.append([(lo, min(lo + chunk, t), chunk)
                    for lo in range(0, t, chunk)])
    return out


def widest_gap(ref: List[torch.Tensor], tokens: List[torch.Tensor]) -> float:
    """max over positions of (best reference logit - logit of the token)."""
    worst = 0.0
    for lg, tok in zip(ref, tokens):
        gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def mean_gap(ref: List[torch.Tensor], tokens: List[torch.Tensor]) -> float:
    """The gap averaged over every position."""
    n = sum(len(t) for t in tokens)
    tot = sum(float((lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0])
                    .sum()) for lg, tok in zip(ref, tokens))
    return tot / max(n, 1)


def worst_mean_gap(ref: List[torch.Tensor],
                   tokens: List[torch.Tensor]) -> float:
    """The gap averaged over each request's positions, the largest over
    the requests: a fault in one request is not averaged away by the
    others."""
    return max((float((lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0])
                      .mean()) for lg, tok in zip(ref, tokens) if len(tok)),
               default=0.0)


def mismatch_share(ref: List[torch.Tensor],
                   tokens: List[torch.Tensor]) -> float:
    """Share of positions whose token is not the reference's first."""
    n = sum(len(t) for t in tokens)
    bad = sum(int((lg.argmax(-1) != tok).sum()) for lg, tok in
              zip(ref, tokens))
    return bad / max(n, 1)


def served_gap(params: dict, arch: D.Arch, sample: List[dict], *,
               chunk: Optional[int] = None, control: bool = False,
               device="cuda") -> dict:
    """The readings a serving cell's limits judge over ``sample`` (dicts
    with ``prompt`` and ``served`` id lists): the widest gap of a served
    token's logit below the reference's best (``served_gap``), the gap's
    mean (``served_mean_gap``) and its largest mean over one request
    (``served_worst_mean_gap``), the share of served tokens that are not
    the reference's first (``served_mismatch``), and ``tokens``.

    With ``control`` the tokens judged are those the fp8 control puts
    first at each position of the same prompts and served tokens: the
    control in the program's place, under the same names."""
    D.strict_float32()
    seqs, at, served = _inputs(sample, device)
    groups = dispatch_groups(sample, arch, chunk)
    ref = D.logits_at(params, arch, seqs, at, groups)
    if control:
        served = [x.argmax(-1) for x in
                  D.logits_at(params, arch, seqs, at, groups, quant="fp8")]
    return {"served_gap": widest_gap(ref, served),
            "served_mismatch": mismatch_share(ref, served),
            "served_mean_gap": mean_gap(ref, served),
            "served_worst_mean_gap": worst_mean_gap(ref, served),
            "tokens": int(sum(len(s) for s in served))}

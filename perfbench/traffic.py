"""The one traffic generator: every mix is a data file it reads.

A mix lives in ``traffic/<name>.json``.  Its ``"loop"`` names the module
``loops/<loop>.py`` that runs it; the two loops here draw their plans
from this file:

* ``"sessions"``: multi-turn chat.  Sessions arrive as an open Poisson
  loop; the turns of one session form a closed loop (a turn is due a
  think time after the previous reply arrived).  Each prompt re-sends the
  session's system prompt and its whole history.
* ``"closed"``: ``clients`` callers, each sending its next request as soon
  as the previous one returned.

Every seed sees the same work.  The sizes (turn counts, prompt and reply
lengths, think times, arrival times) are drawn once
from the mix's ``plan_seed``; the run's seed only shuffles which session
or client gets which of them and draws the token ids.  So two seeds
differ in order and content, never in the amount of work.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<root>/<kind>/<name>.json``, e.g. ``traffic/chat-sessions``."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of one run: any whole seed, also
    past 32 bits or negative, maps to a fixed entropy word."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def lognormal_ints(g: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` lengths from a lognormal of ``median`` and ``sigma`` (of the
    log), rounded and clipped to ``[min, max]``."""
    z = g.standard_normal(n)
    v = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def loguniform_ints(g: np.random.Generator, spec: dict,
                    n: int) -> np.ndarray:
    """``n`` lengths log-uniform in ``[min, max]``."""
    lo, hi = np.log(spec["min"]), np.log(spec["max"] + 1)
    return np.clip(np.exp(g.uniform(lo, hi, n)).astype(np.int64),
                   spec["min"], spec["max"])


def on_grid(n: int, mix: dict) -> int:
    """``n`` rounded up to the mix's ``prompt_grid``: every prompt width a
    mix sends is a multiple of it, so that a run's prompts take few
    distinct widths (the server plans its page decode once per width, and
    refuses a width past its 64th)."""
    q = mix.get("prompt_grid", 1)
    return -(-n // q) * q


def tokens(g: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """``n`` token ids, uniform over the vocabulary."""
    return g.integers(0, vocab, n, dtype=np.int64)


# -- sessions ------------------------------------------------------------------

@dataclasses.dataclass
class Turn:
    user: int           # user tokens appended to the history
    reply: int          # tokens the server generates
    think_s: float      # pause before the next turn is sent


@dataclasses.dataclass
class Session:
    arrival_s: float    # offset from the open of the loop
    system: int         # which system prompt it starts from
    turns: List[Turn]


def session_sizes(mix: dict, count: int, span_s: float,
                  plan_seed: int) -> List[Session]:
    """``count`` sessions in arrival order, their sizes drawn from
    ``plan_seed`` alone.  Arrival times are a Poisson process conditioned
    on ``count`` arrivals in ``[0, span_s)``; a session's turns stop
    before its context would pass ``context_cap``."""
    g = rng(plan_seed, 1)
    arrivals = np.sort(g.uniform(0.0, span_s, count))
    sp = mix["system_prompts"]
    systems = g.choice(len(sp["weights"]), size=count, p=sp["weights"])
    n_turns = g.integers(mix["turns"]["min"], mix["turns"]["max"] + 1, count)
    out = []
    for i in range(count):
        n = int(n_turns[i])
        users = lognormal_ints(g, mix["user_tokens"], n)
        replies = lognormal_ints(g, mix["reply_tokens"], n)
        thinks = g.exponential(mix["think_s_mean"], n)
        ctx, turns = sp["length"], []
        for u, r, th in zip(users, replies, thinks):
            u = on_grid(ctx + int(u), mix) - ctx
            if ctx + u + r > mix["context_cap"]:
                break
            turns.append(Turn(u, int(r), float(th)))
            ctx += u + int(r)
        out.append(Session(float(arrivals[i]), int(systems[i]), turns))
    return out


def session_plan(mix: dict, seed: int, span_s: float, rate: float,
                 warmup: bool = False) -> List[Session]:
    """The sessions arriving in ``span_s`` seconds at ``rate`` a second:
    the fixed sizes of the mix, shuffled by ``seed`` (arrival times stay
    sorted; which session arrives at which time is the shuffle)."""
    count = max(1, int(round(rate * span_s)))
    sizes = session_sizes(mix, count, span_s,
                          mix["plan_seed"] + (1 if warmup else 0))
    order = rng(seed, 2, int(warmup)).permutation(count)
    arrivals = [s.arrival_s for s in sizes]
    return [dataclasses.replace(sizes[j], arrival_s=arrivals[i])
            for i, j in enumerate(order)]


def system_prompts(mix: dict, seed: int, vocab: int) -> List[np.ndarray]:
    sp = mix["system_prompts"]
    g = rng(seed, 3)
    return [tokens(g, sp["length"], vocab) for _ in sp["weights"]]


def user_tokens(seed: int, session: int, turn: int, n: int, vocab: int,
                warmup: bool = False) -> np.ndarray:
    return tokens(rng(seed, 4, int(warmup), session, turn), n, vocab)


# -- closed loop ---------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt: int
    new: int


def closed_plan(mix: dict, seed: int) -> List[List[Request]]:
    """Each client's cycle of requests: the mix's fixed ``clients``
    sequences of ``per_client`` (prompt, output) pairs, dealt to the
    clients in an order drawn from ``seed``.  A client runs through its
    sequence again and again."""
    n, k = mix["clients"], mix["per_client"]
    g = rng(mix["plan_seed"], 5)
    prompts = [on_grid(int(p), mix)
               for p in loguniform_ints(g, mix["prompt_tokens"], n * k)]
    news = lognormal_ints(g, mix["output_tokens"], n * k)
    seqs = [[Request(prompts[i], int(news[i])) for i in range(c * k,
                                                             (c + 1) * k)]
            for c in range(n)]
    return [seqs[j] for j in rng(seed, 6).permutation(n)]


def closed_prompt(seed: int, client: int, index: int, n: int,
                  vocab: int) -> np.ndarray:
    return tokens(rng(seed, 7, client, index), n, vocab)

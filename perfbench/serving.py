"""A serving cell: the port's served path under a traffic mix.

The harness process builds the engine on weights made from the seed,
the paged batcher and the RPC server (``build_server``) on a loopback
port; the load client runs in a child process of its own
(:mod:`client`), so its CPU work does not contend with the server's.
Requests go through ``Infer``: the front door, page ingest (decoded on
the card), the ``PagedBatcher`` with its prefix cache, chunked prefill
and speculative decode, the paged attention kernels, and the response
page.  (``InferStream`` runs each stream through ``Engine.generate``
alone, outside the batcher.)

When each token of a request is produced is read through the batcher's
``on_token`` hook: :class:`TokenClock` stands in front of the batcher
and adds a hook that stamps each token on the monotonic clock, keyed by
a hash of the prompt the server decoded.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import harness as H
import weights as WT
from client import prompt_key

HERE = Path(__file__).resolve().parent


def note(t0: float, what: str) -> None:
    """A line on standard error: seconds since ``t0`` and what is done."""
    print(f"[{time.monotonic() - t0:8.2f} s] {what}", file=sys.stderr,
          flush=True)


def model_config(conf: dict):
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


class TokenClock:
    """Stands in front of a batcher: every ``submit`` gets an ``on_token``
    hook that stamps the request's tokens on the monotonic clock.
    Everything else passes through to the batcher."""

    def __init__(self, batcher):
        self._batcher = batcher
        self._lock = threading.Lock()
        self.requests: Dict[str, List[dict]] = {}

    def submit(self, tokens, **kw):
        tokens = np.atleast_2d(tokens)
        rec = {"submit": time.monotonic(), "emits": [],
               "plen": int(tokens.shape[1])}
        with self._lock:
            self.requests.setdefault(prompt_key(tokens[0]), []).append(rec)
        inner = kw.get("on_token")

        def on_token(i, tok, rec=rec):
            rec["emits"].append(time.monotonic())
            if inner is not None:
                inner(i, tok)
        kw["on_token"] = on_token
        return self._batcher.submit(tokens, **kw)

    def __getattr__(self, name):
        return getattr(self._batcher, name)


class ClientProcess:
    """The load client as a child process, spoken to by lines."""

    def __init__(self, bench: H.Bench, seed: int, seconds: float,
                 vocab: int, rate: Optional[float] = None,
                 warmup: bool = True):
        self.log = tempfile.TemporaryFile(mode="w+")
        argv = [sys.executable, str(HERE / "client.py"),
                "--traffic", bench.cell["traffic"], "--seed", str(seed),
                "--seconds", str(seconds), "--vocab", str(vocab),
                "--warmup", str(int(warmup)),
                "--traffic-root", str(bench.dir)]
        if rate is not None:
            argv += ["--rate", str(rate)]
        env = dict(os.environ)
        src = H.find_src(bench.root)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(src)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                          else []))
        env["OMP_NUM_THREADS"] = "1"
        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self.log,
                                     text=True, env=env)

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def expect(self, key: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            self.log.seek(0)
            tail = self.log.read()[-4000:]
            raise RuntimeError(f"load client ended before {key!r}: {tail}")
        msg = json.loads(line)
        if key not in msg:
            raise RuntimeError(f"load client said {msg!r}, wanted {key!r}")
        return msg

    def close(self, timeout: float = 30.0) -> int:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()
        finally:
            self.log.close()


@dataclasses.dataclass
class Window:
    open_t: float
    close_t: float
    stats0: dict
    stats1: dict
    records: list
    sample: list
    server: Dict[str, List[dict]]
    trace: Optional[object] = None   # what the window's tracer returned


class ServeCell:
    """Engine, batcher and server for one cell, built once; windows of
    traffic run against it."""

    def __init__(self, bench: H.Bench, seed: int, device, t0: float):
        import torch
        from repro_torch.serving import Engine, ServeConfig
        from repro_torch.serving.engine import PagedBatcher
        from repro_torch.serving.service import InferenceImpl, build_server
        self.bench, self.seed, self.t0 = bench, seed, t0
        self.torch = torch
        self.cfg = model_config(bench.conf)
        dtype = getattr(torch, self.cfg.dtype)
        params = WT.make(self.cfg, seed, device, dtype)
        self.sync()
        note(t0, "weights made")
        self.engine = Engine(self.cfg, ServeConfig(**bench.mix["server"]),
                             params=params, device=device)
        self.clock = TokenClock(PagedBatcher(self.engine))
        self.impl = InferenceImpl(self.engine, batcher=self.clock)
        self.server = build_server(self.engine, impl=self.impl)
        _, self.port, self.lsock = self.server.listen_tcp()
        note(t0, "server listening")

    def window(self, client: ClientProcess, tracer=None) -> Window:
        """One window of the mix: the client warms up, the window opens,
        closes, and the client reports."""
        client.send(f"port {self.port}")
        client.expect("ready")
        self.sync()
        note(self.t0, "client warmed up")
        client.send("open")
        open_t = client.expect("open")["open"]
        stats0 = self.clock.collect_stats()
        trace = tracer(open_t) if tracer is not None else None
        close_t = client.expect("closed")["closed"]
        stats1 = self.clock.collect_stats()
        rep = client.expect("records")
        with self.clock._lock:
            server = {k: list(v) for k, v in self.clock.requests.items()}
            self.clock.requests.clear()
        return Window(open_t, close_t, stats0, stats1, rep["records"],
                      rep["sample"], server, trace)

    def sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def close(self) -> None:
        """Stop the server and the batcher's worker, free the weights."""
        self.server.drain(timeout=10.0)
        self.impl.close()
        self.lsock.close()
        del self.impl, self.clock, self.server
        self.engine.params = None
        self.engine = None


def merge(w: Window) -> List[dict]:
    """Client records joined with the server's token stamps: each gets
    ``first``/``last`` (monotonic) and ``emits``."""
    used: Dict[str, int] = {}
    out = []
    for r in sorted(w.records, key=lambda r: r["sent"]):
        k = r["key"]
        recs = w.server.get(k, [])
        i = used.get(k, 0)
        s = recs[i] if i < len(recs) else None
        used[k] = i + 1
        m = dict(r)
        if s is not None and s["emits"]:
            m["first"], m["last"] = s["emits"][0], s["emits"][-1]
            m["emits"] = s["emits"]
        else:
            m["first"] = m["last"] = None
            m["emits"] = []
        out.append(m)
    return out


def end_to_end(w: Window, reqs: List[dict]) -> Dict[str, float]:
    """The serving end-to-end metrics every loop supports; a loop adds
    its own (:mod:`loops.sessions` its time to first token)."""
    span = w.close_t - w.open_t
    done = [r for r in reqs if r["ok"] and r["first"] is not None]
    # tokens the server produced for its clients inside the window, each
    # stamped as the batcher emitted it (Infer returns a request's tokens
    # together at its end, so counting at the return would make the rate
    # jump by whole requests)
    out = {"serve_tokens_per_s": sum(
        1 for rs in w.server.values() for r in rs for t in r["emits"]
        if w.open_t <= t < w.close_t) / span}
    tpot = [(r["last"] - r["first"]) / (r["n"] - 1) * 1e3
            for r in done if r["n"] > 1]
    if tpot:
        out["tpot_p95_ms"] = H.percentile(tpot, 95)
    return out


def window_records(bench: H.Bench, w: Window, reqs: List[dict]) -> dict:
    """What the per-layer metric files read about a serving window."""
    submitted = sum(r["plen"] for rs in w.server.values() for r in rs
                    if w.open_t <= r["submit"] < w.close_t)
    return {"kind": "serve",
            "conf": bench.conf, "server": bench.mix["server"],
            "open": w.open_t, "close": w.close_t,
            "window_s": w.close_t - w.open_t,
            "stats0": w.stats0, "stats1": w.stats1, "requests": reqs,
            "server_requests": [r for rs in w.server.values() for r in rs],
            "prompt_tokens_submitted": submitted}


def run(bench: H.Bench, seed: int, seconds: float, trace: bool, device,
        t0: float, *, control: bool = False) -> dict:
    """One run of a serving cell: set-up, the window, then (the program's
    state freed) the comparison with the reference.  ``readings`` holds
    the numbers the cell's limits judge: the program's tokens', or with
    ``control`` the fp8 control's, put in the program's place under the
    same names."""
    import torch
    import tracing
    from reference import compare as C
    from reference.decoder import Arch
    mix = bench.mix
    # the client imports while the server builds
    client = ClientProcess(bench, seed, seconds, bench.conf["vocab_size"])
    try:
        cell = ServeCell(bench, seed, device, t0)
    except BaseException:
        client.close(timeout=1.0)
        raise
    tracer = None
    if trace:
        def tracer(open_t):
            return tracing.trace(mix["trace_s"], open_t + mix["trace_delay_s"])
    try:
        w = cell.window(client, tracer)
    finally:
        code = client.close()
    if code != 0:
        raise RuntimeError(f"load client exited with {code}")
    reqs = merge(w)
    rec = window_records(bench, w, reqs)
    rec["e2e"] = end_to_end(w, reqs)
    if w.trace is not None:
        rec["trace"] = tracing.reduce(w.trace)
    on_card = cell.engine.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    cell.close()
    del cell
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        print(f"after the window: {torch.cuda.memory_allocated() / 1e9:.2f}"
              f" GB still allocated", file=sys.stderr)
    note(t0, "window closed, the program's state freed")
    arch = Arch.from_config(bench.conf)
    params = WT.make(model_config(bench.conf), seed, device,
                     getattr(torch, bench.conf["torch_dtype"]))
    chunk = None if arch.moe_free() else mix["server"]["prefill_chunk"]
    gap = C.served_gap(params, arch, w.sample, chunk=chunk, control=control,
                       device=device)
    del params
    note(t0, "reference compared")
    return {"setup_s": w.open_t - t0, "rec": rec, "peak": peak,
            "attempted": len(reqs),
            "failed": sum(1 for r in reqs if not r["ok"]),
            "sample": w.sample, "readings": gap}

"""Serving launcher: the port's Bebop-RPC inference server over TCP.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --full
    python -m repro_torch.launch.serve --arch qwen2-1.5b --full --replicas 2

A port of the JAX package's ``launch/serve.py``.  With one replica it
builds the :class:`~repro_torch.serving.Engine` on the card (``main(...,
device="cpu")`` runs the plain PyTorch path), serves the full §7 protocol
(``build_server``: the nine ``InferenceService`` methods, batch
pipelining, futures, cursors, deadlines), and on SIGTERM/SIGINT drains:
new calls are refused, health probes answered, calls in flight finished.
``--once`` serves one ``Generate`` probe over TCP and exits.

With ``--replicas N`` (N > 1) the launcher becomes the replicated tier:
a :class:`ReplicaSupervisor` spawns N engine subprocesses (each this
same launcher on an ephemeral port, on the device the caller of
:func:`main` asked for), restarts crashed ones under capped
``RetryPolicy`` backoff, and the exported port serves the
``serving/router.py`` front door — health-gated routing, per-replica
circuit breakers, keyed failover, hedged Infer, prefix affinity.  The
router process only proxies bytes and never touches the card.  SIGHUP
triggers a rolling restart (each replica is SIGTERMed, drains, and comes
back before the next one goes down); SIGTERM/SIGINT drain the router and
then the replicas.

The parser matches the JAX launcher's flag for flag.
"""
import argparse
import re
import sys
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    """The launcher's flag surface, buildable without side effects: the
    JAX launcher's, flag for flag."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per paged-KV block (rounded up to a "
                         "64B-aligned stride)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens prefilled per chunked step")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool size in blocks (0 = auto from max-batch)")
    ap.add_argument("--max-step-tokens", type=int, default=0,
                    help="budget of NEW tokens per fused step: decode rows "
                         "cost 1 each, prefilling rows share the remainder "
                         "up to --prefill-chunk (0 = no budget)")
    ap.add_argument("--blocking-prefill", action="store_true",
                    help="disable fused prefill/decode steps: admission "
                         "runs a request's whole chunked prefill before "
                         "in-flight rows take their next decode step "
                         "(baseline scheduler)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="automatic prefix caching: match new prompts "
                         "block-by-block against resident prefixes and "
                         "share (refcount) the matched KV blocks instead "
                         "of re-prefilling them (--no-prefix-cache to "
                         "disable)")
    ap.add_argument("--prefix-lru-blocks", type=int, default=0,
                    help="cap on cached-but-unreferenced prefix blocks "
                         "kept resident between requests (0 = bounded "
                         "only by the pool; idle entries are evicted "
                         "when an allocation runs short)")
    ap.add_argument("--spec-decode", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="self-speculative decoding: an n-gram drafter "
                         "over each request's own tokens proposes up to "
                         "--spec-len continuations and one fused verify "
                         "step scores them all; output tokens are "
                         "identical to plain greedy decode "
                         "(--no-spec-decode to disable)")
    ap.add_argument("--spec-len", type=int, default=4,
                    help="max drafted tokens per request per decode step")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="shortest suffix n-gram the drafter may match "
                         "against the request's history")
    ap.add_argument("--swap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="SLO-aware preemption: under pool pressure, page "
                         "the KV blocks of lowest-priority requests out "
                         "to host memory and resume them token-identically "
                         "later, instead of shedding (--no-swap to "
                         "disable)")
    ap.add_argument("--default-priority", type=int, default=0,
                    help="priority class for requests that don't carry "
                         "one (higher wins; preemption only ever claims "
                         "strictly-lower victims)")
    ap.add_argument("--ttft-slo-ms", type=float, default=0.0,
                    help="default time-to-first-token target in ms "
                         "(0 = no target); drives the SLO controller "
                         "and the slo_violations counter")
    ap.add_argument("--tpot-slo-ms", type=float, default=0.0,
                    help="default inter-token latency target in ms "
                         "(0 = no target)")
    ap.add_argument("--slo-adjust-every", type=int, default=16,
                    help="scheduler steps between SLO-controller updates "
                         "to the live --max-step-tokens budget")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="default sampling temperature for requests that "
                         "don't carry one (0 = greedy argmax, the "
                         "historical behavior; per-request temperature "
                         "overrides)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="default top-k sampling filter: keep only the k "
                         "highest-probability tokens before drawing "
                         "(0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="default nucleus-sampling filter: keep the "
                         "smallest token set with cumulative probability "
                         ">= top_p (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="default sampling seed for requests that don't "
                         "carry one; same seed + same prompt => same "
                         "tokens, independent of batch composition")
    ap.add_argument("--dense-cache", action="store_true",
                    help="disable the paged KV cache / mixed-length "
                         "scheduler and serve with the dense batcher")
    ap.add_argument("--full", action="store_true",
                    help="serve the full model configuration instead of "
                         "the reduced (CI-sized) one")
    ap.add_argument("--once", action="store_true",
                    help="start, print the port, serve one probe, exit "
                         "(smoke-test mode)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="graceful-shutdown budget in seconds: on "
                         "SIGTERM/SIGINT the server stops admitting new "
                         "calls (health probes still answer), finishes "
                         "what is in flight up to this long, then closes "
                         "every listener and connection")
    ap.add_argument("--replicas", type=int, default=1,
                    help="N > 1 serves the replicated tier: N engine "
                         "subprocesses under a crash-restarting "
                         "supervisor, fronted by the health-gated "
                         "failover/hedging router (1 = single process, "
                         "no router)")
    ap.add_argument("--hedge", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="hedge Infer calls: fire a second, cancellable "
                         "attempt on another replica once a call "
                         "outlives the observed latency quantile; first "
                         "response wins (--no-hedge to disable)")
    ap.add_argument("--hedge-delay-ms", type=float, default=50.0,
                    help="hedging delay before latency history exists "
                         "(once 16+ calls are observed, the p95 of "
                         "recent latencies is used instead)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive transport failures that open a "
                         "replica's circuit breaker (routing skips an "
                         "open replica)")
    ap.add_argument("--breaker-reset-s", type=float, default=5.0,
                    help="seconds an open breaker waits before letting "
                         "one half-open probe through")
    ap.add_argument("--affinity-prefix", type=int, default=64,
                    help="leading prompt tokens (rounded down to a "
                         "block multiple) consistently hashed for "
                         "replica affinity, so shared prefixes hit the "
                         "same replica's prefix cache (0 = route purely "
                         "by load)")
    ap.add_argument("--health-interval-s", type=float, default=1.0,
                    help="router health-poll period per replica; drain "
                         "state, inflight and queue depth from these "
                         "probes gate and score routing")
    return ap


class ReplicaSupervisor:
    """Spawns and babysits N replica processes.

    ``spawn(index)`` returns a process handle exposing ``poll()`` (None
    while running, exit code after), ``terminate()`` and
    ``wait(timeout)`` — the subprocess surface, so tests drive the
    supervisor with stub handles and zero wall clock.  A crashed replica
    is respawned after a capped :class:`RetryPolicy` backoff keyed to its
    consecutive-crash count; surviving ``stable_after_s`` resets the
    count, so a one-off crash does not inherit crash-loop delays.
    ``rolling_restart()`` takes replicas down one at a time through the
    graceful SIGTERM drain path.
    """

    def __init__(self, spawn, count: int, *, policy=None,
                 stable_after_s: float = 10.0,
                 poll_interval_s: float = 0.5,
                 sleep=None, clock=time.monotonic, rng=None,
                 on_event=None):
        from ..core.retry import RetryPolicy
        self._spawn = spawn
        self.count = count
        self.policy = policy or RetryPolicy(
            attempts=8, base_delay=0.5, multiplier=2.0, max_delay=30.0,
            jitter=0.25)
        self.stable_after_s = stable_after_s
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        # default sleep is interruptible so stop() never waits a backoff
        self._sleep = sleep if sleep is not None else self._stop.wait
        self._clock = clock
        self._rng = rng
        self._on_event = on_event
        self.handles: list = [None] * count
        self.failures = [0] * count    # consecutive crashes per slot
        self._started_at = [0.0] * count
        self.restarts = 0
        self._thread = None

    def _event(self, msg: str) -> None:
        if self._on_event is not None:
            self._on_event(msg)
        else:
            print(f"[supervisor] {msg}", flush=True)

    def start(self) -> None:
        for i in range(self.count):
            self.handles[i] = self._spawn(i)
            self._started_at[i] = self._clock()
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="replica-supervisor")
        self._thread.start()

    def check(self) -> None:
        """One monitor pass (the poll loop calls this; tests call it
        directly)."""
        for i in range(self.count):
            h = self.handles[i]
            if h is None:
                continue
            if h.poll() is None:
                if self.failures[i] and self._clock() - self._started_at[i] \
                        >= self.stable_after_s:
                    self.failures[i] = 0   # stayed up: forgive the past
                continue
            if self._stop.is_set():
                return
            self.failures[i] += 1
            delay = self.policy.delay(
                min(self.failures[i], self.policy.attempts), self._rng)
            self._event(f"replica {i} exited (code {h.poll()}); "
                        f"restart {self.failures[i]} in {delay:.2f}s")
            self._sleep(delay)
            if self._stop.is_set():
                return
            try:
                self.handles[i] = self._spawn(i)
            except Exception as e:  # noqa: BLE001 - spawn failure = crash
                self._event(f"replica {i} respawn failed: {e}")
                continue           # counted again next pass, longer delay
            self._started_at[i] = self._clock()
            self.restarts += 1

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.check()

    def rolling_restart(self, *, drain_timeout: float = 30.0) -> None:
        """Replace every replica one at a time via graceful drain."""
        for i in range(self.count):
            h = self.handles[i]
            if h is not None:
                h.terminate()          # SIGTERM -> the child drains
                try:
                    h.wait(drain_timeout)
                except Exception:  # noqa: BLE001 - replace it regardless
                    pass
            self.handles[i] = self._spawn(i)
            self._started_at[i] = self._clock()
            self.restarts += 1
            self._event(f"replica {i} rolled")

    def stop(self, *, timeout: float = 10.0) -> None:
        self._stop.set()
        for h in self.handles:
            if h is None:
                continue
            try:
                h.terminate()
                h.wait(timeout)
            except Exception:  # noqa: BLE001 - already going away
                pass
        if self._thread is not None:
            self._thread.join(timeout=timeout)


#: the line every launcher prints once it is listening; the supervisor
#: parses the child's ephemeral port out of it
_SERVING_RE = re.compile(r"bebop-rpc serving .+ on ([\w.\-]+):(\d+)")


class _ProcHandle:
    """Subprocess + the (host, port) parsed from its startup line."""

    def __init__(self, proc, host, port):
        self.proc = proc
        self.host = host
        self.port = port

    def poll(self):
        return self.proc.poll()

    def terminate(self) -> None:
        self.proc.terminate()

    def wait(self, timeout=None):
        return self.proc.wait(timeout=timeout)


#: a replica's bootstrap: this launcher's ``main`` on the device the
#: caller asked for.  The device rides in the code, not in a flag or the
#: environment, so a child can never land on the CPU unasked: one that
#: finds no CUDA when asked for the card raises and exits nonzero, and the
#: supervisor counts that as a crash.
_CHILD_BOOT = ("import sys; from repro_torch.launch.serve import main; "
               "sys.exit(main(sys.argv[1:], device={device!r}))")


def _child_argv(args, device) -> list:
    """Launcher argv for one engine replica: same flags, ephemeral port,
    the caller's device."""
    argv = [sys.executable, "-c", _CHILD_BOOT.format(device=str(device)),
            "--arch", args.arch, "--host", args.host, "--port", "0",
            "--cache-len", str(args.cache_len),
            "--max-new-tokens", str(args.max_new_tokens),
            "--max-batch", str(args.max_batch),
            "--block-size", str(args.block_size),
            "--prefill-chunk", str(args.prefill_chunk),
            "--num-blocks", str(args.num_blocks),
            "--max-step-tokens", str(args.max_step_tokens),
            "--prefix-lru-blocks", str(args.prefix_lru_blocks),
            "--spec-len", str(args.spec_len),
            "--spec-ngram", str(args.spec_ngram),
            "--default-priority", str(args.default_priority),
            "--ttft-slo-ms", str(args.ttft_slo_ms),
            "--tpot-slo-ms", str(args.tpot_slo_ms),
            "--slo-adjust-every", str(args.slo_adjust_every),
            "--temperature", str(args.temperature),
            "--top-k", str(args.top_k),
            "--top-p", str(args.top_p),
            "--seed", str(args.seed),
            "--drain-timeout", str(args.drain_timeout),
            "--prefix-cache" if args.prefix_cache else "--no-prefix-cache",
            "--spec-decode" if args.spec_decode else "--no-spec-decode",
            "--swap" if args.swap else "--no-swap"]
    if args.blocking_prefill:
        argv.append("--blocking-prefill")
    if args.dense_cache:
        argv.append("--dense-cache")
    if args.full:
        argv.append("--full")
    return argv


def _spawn_child(argv):
    """Popen a replica, read its startup line for the ephemeral port.

    Replicas that start together may build the same missing kernel
    library together: each ``nvcc`` writes a file named by its own pid and
    ``os.replace``s it into place (``kernels/build.py``), so the last
    rename wins with identical bytes and no lock is needed."""
    import subprocess
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    host = port = None
    while True:
        line = proc.stdout.readline()
        if not line:               # died before listening
            code = proc.wait()
            raise RuntimeError(f"replica exited during startup (code {code})")
        m = _SERVING_RE.search(line)
        if m:
            host, port = m.group(1), int(m.group(2))
            break

    def drain_pipe():              # keep the child's pipe from filling
        for _ in proc.stdout:
            pass

    threading.Thread(target=drain_pipe, daemon=True,
                     name="replica-stdout").start()
    return _ProcHandle(proc, host, port)


def _serve_replicated(args, device) -> int:
    from ..core.rpc import TcpTransport
    from ..serving.router import RouterConfig, build_router_server

    sup = ReplicaSupervisor(
        lambda i: _spawn_child(_child_argv(args, device)), args.replicas)
    sup.start()

    def make_dial(slot: int):
        # reads the supervisor's CURRENT handle: after a crash-restart
        # the replica lives on a fresh ephemeral port, and the next dial
        # finds it without the router ever being reconfigured
        def dial():
            h = sup.handles[slot]
            if h is None or h.poll() is not None:
                raise ConnectionError(f"replica {slot} is down")
            return TcpTransport.connect(h.host, h.port)
        return dial

    rcfg = RouterConfig(hedge=args.hedge,
                        hedge_delay_ms=args.hedge_delay_ms,
                        breaker_threshold=args.breaker_threshold,
                        breaker_reset_s=args.breaker_reset_s,
                        affinity_prefix=args.affinity_prefix,
                        affinity_block=args.block_size,
                        health_interval_s=args.health_interval_s)
    server, router = build_router_server(
        [make_dial(i) for i in range(args.replicas)], rcfg)
    host, port, _ = server.listen_tcp(args.host, args.port)
    print(f"bebop-rpc serving {args.arch} on {host}:{port} "
          f"(router, {args.replicas} replicas, {device})", flush=True)

    if args.once:
        import numpy as np
        from ..core.rpc import Channel
        from ..serving.service import InferenceService
        ch = Channel(TcpTransport.connect(host, port))
        try:
            inf = ch.typed(InferenceService)
            prompt = np.arange(8, dtype=np.uint32) % 32000
            res = inf.Generate({"tokens": prompt, "batch": 1, "seq_len": 8,
                                "max_new_tokens": 4}, timeout=120.0)
            print("probe generated", res["new_tokens"], "tokens via router",
                  flush=True)
        finally:
            ch.close()
            server.drain(timeout=args.drain_timeout)
            router.close()
            sup.stop(timeout=args.drain_timeout)
        return 0

    import signal
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, on_signal)
        except ValueError:
            pass
    try:                           # SIGHUP = rolling restart
        signal.signal(signal.SIGHUP, lambda s, f: threading.Thread(
            target=sup.rolling_restart,
            kwargs={"drain_timeout": args.drain_timeout},
            daemon=True).start())
    except (ValueError, AttributeError):
        pass

    stop.wait()
    print(f"draining router (timeout {args.drain_timeout:g}s)...",
          flush=True)
    completed = server.drain(timeout=args.drain_timeout)
    router.close()
    sup.stop(timeout=args.drain_timeout)
    print("drain complete" if completed
          else "drain timeout: exiting with calls in flight", flush=True)
    return 0 if completed else 1

def main(argv=None, *, device="cuda") -> int:
    """Serve until SIGTERM/SIGINT (or one probe with ``--once``); returns
    the exit code: 0 once drained (or probed), 1 if the drain timed out.
    ``device`` places the engine (of every replica, with ``--replicas``):
    the card unless the caller asks for the CPU, and an error where CUDA
    is missing."""
    args = build_parser().parse_args(argv)
    if args.replicas > 1:
        return _serve_replicated(args, device)

    from ..configs import get_config, reduced_config
    from ..serving import Engine, ServeConfig, build_server

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    engine = Engine(cfg, ServeConfig(cache_len=args.cache_len,
                                     max_new_tokens=args.max_new_tokens,
                                     max_batch=args.max_batch,
                                     paged=not args.dense_cache,
                                     block_size=args.block_size,
                                     prefill_chunk=args.prefill_chunk,
                                     num_blocks=args.num_blocks,
                                     fused_prefill=not args.blocking_prefill,
                                     max_step_tokens=args.max_step_tokens,
                                     prefix_cache=args.prefix_cache,
                                     prefix_lru_blocks=args.prefix_lru_blocks,
                                     spec_decode=args.spec_decode,
                                     spec_len=args.spec_len,
                                     spec_ngram=args.spec_ngram,
                                     swap=args.swap,
                                     default_priority=args.default_priority,
                                     ttft_slo_ms=args.ttft_slo_ms,
                                     tpot_slo_ms=args.tpot_slo_ms,
                                     slo_adjust_every=args.slo_adjust_every,
                                     temperature=args.temperature,
                                     top_k=args.top_k,
                                     top_p=args.top_p,
                                     seed=args.seed),
                    device=device)
    server = build_server(engine)
    host, port, _ = server.listen_tcp(args.host, args.port)
    mode = "paged" if not args.dense_cache and engine.supports_paged \
        else "dense"
    print(f"bebop-rpc serving {cfg.name} on {host}:{port} "
          f"({mode} KV cache, {engine.device})", flush=True)

    if args.once:
        import numpy as np
        from ..core.rpc import Channel, TcpTransport
        from ..serving.service import InferenceService
        ch = Channel(TcpTransport.connect(host, port))
        try:
            inf = ch.typed(InferenceService)
            prompt = np.arange(8, dtype=np.uint32) % cfg.vocab_size
            res = inf.Generate({"tokens": prompt, "batch": 1, "seq_len": 8,
                                "max_new_tokens": 4})
            print("probe generated", res["new_tokens"], "tokens:",
                  list(res["tokens"])[:8], flush=True)
        finally:
            ch.close()
            server.drain(timeout=args.drain_timeout)
        return 0

    # Graceful drain: SIGTERM (orchestrator shutdown) and SIGINT flip an
    # event; the main thread then drains — new calls refused, health
    # probes answered, in-flight work finished — before exiting.
    import signal
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, on_signal)
        except ValueError:  # non-main thread (embedding/tests)
            pass

    stop.wait()
    print(f"draining (timeout {args.drain_timeout:g}s)...", flush=True)
    completed = server.drain(timeout=args.drain_timeout)
    print("drain complete" if completed
          else "drain timeout: exiting with calls in flight", flush=True)
    return 0 if completed else 1


if __name__ == "__main__":
    sys.exit(main())

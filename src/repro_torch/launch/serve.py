"""Serving launcher: the port's Bebop-RPC inference server over TCP.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --full

A port of the JAX package's ``launch/serve.py`` for one replica: it builds
the :class:`~repro_torch.serving.Engine` on the card (``main(...,
device="cpu")`` runs the plain PyTorch path), serves the full §7 protocol
(``build_server``: the nine ``InferenceService`` methods, batch
pipelining, futures, cursors, deadlines), and on SIGTERM/SIGINT drains:
new calls are refused, health probes answered, calls in flight finished.
``--once`` serves one ``Generate`` probe over TCP and exits.

The parser matches the JAX launcher's flag for flag.  ``--replicas N``
with N > 1 (the router tier and its flags) is not ported: it raises.
"""
import argparse
import sys

def build_parser() -> argparse.ArgumentParser:
    """The launcher's flag surface, buildable without side effects: the
    JAX launcher's, flag for flag (``--replicas`` and the router flags
    included, though this launcher serves one replica)."""
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


_REPLICAS_TODO = ("--replicas > 1 needs the replica router, which the port "
                  "does not carry yet (ROADMAP.md, Queue 1 item 8: fleet "
                  "tier)")


def main(argv=None, *, device="cuda") -> int:
    """Serve until SIGTERM/SIGINT (or one probe with ``--once``); returns
    the exit code: 0 once drained (or probed), 1 if the drain timed out.
    ``device`` places the engine: the card unless the caller asks for the
    CPU, and an error where CUDA is missing."""
    args = build_parser().parse_args(argv)
    if args.replicas > 1:
        raise NotImplementedError(_REPLICAS_TODO)

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
    import threading
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

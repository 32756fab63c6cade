"""Serving: the inference service, its schedulers and the engine.

  * :mod:`.ingest` — prompt pages are header-validated, placed on the
    device raw and decoded by the ``bebop_decode`` CUDA kernel behind a
    schema-hash plan cache.
  * :mod:`.kv_cache` — the block-pooled paged KV cache (refcounted
    allocator, prefix cache with copy-on-write, swap tier).
  * :mod:`.sampling` — seeded temperature / top-k / top-p sampling and
    rejection-sampled draft verification, the key schedule computed by a
    numpy threefry2x32 that gives ``jax.random``'s bits.
  * :mod:`.engine` — :class:`Engine` (dense generation, greedy or
    sampled, resumable from a cursor; scoring), the dense
    :class:`ContinuousBatcher` and the :class:`PagedBatcher` (fused
    prefill/decode steps, prefix sharing, n-gram speculative decode via
    :mod:`.spec`, ``n > 1`` forks, swap preemption, shedding, the dense
    fallback).
  * :mod:`.service` — the Bebop RPC ``InferenceService`` (nine methods)
    and :func:`build_server`; :class:`InferenceImpl` ``infer`` and
    ``score_page`` call the ``Infer`` and ``ScorePage`` handlers in
    process.
  * :mod:`.router` — the replicated tier: a Bebop-RPC front door over N
    replicas (health-gated routing, circuit breakers, keyed failover,
    cursor-resumed stream failover, hedged ``Infer``, prefix affinity)
    and :class:`InProcessReplica`, a killable replica over a shared
    engine.
"""
from .engine import (ContinuousBatcher, Engine, PagedBatcher,  # noqa: F401
                     ServeConfig, ShedError)
from .ingest import DecodePlan, IngestResult, PageIngest, PlanCache  # noqa: F401
from .kv_cache import (BlockAllocator, CacheOOM, PagedKVCache,  # noqa: F401
                       PrefixCache, aligned_block_size, block_keys)
from .router import (CircuitBreaker, InProcessReplica,  # noqa: F401
                     Replica, ReplicaRouter, RouterConfig,
                     build_router_server)
from .sampling import GREEDY, GenerationParams, SamplingParams  # noqa: F401
from .service import (InferenceImpl, InferenceService,  # noqa: F401
                      build_server, decode_token_page, encode_gen_page,
                      encode_prompt_page)
from .spec import ngram_propose  # noqa: F401

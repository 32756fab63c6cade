"""Serving: the page-level inference and scoring paths.

  * :mod:`.ingest` — prompt pages are header-validated, placed on the
    device raw and decoded by the ``bebop_decode`` CUDA kernel behind a
    schema-hash plan cache.
  * :mod:`.kv_cache` — the block-pooled paged KV cache (refcounted
    allocator, prefix cache with copy-on-write, swap tier).
  * :mod:`.engine` — :class:`Engine` (dense greedy generation, scoring),
    the dense :class:`ContinuousBatcher` and the greedy
    :class:`PagedBatcher` (fused prefill/decode steps, prefix sharing,
    n-gram speculative decode via :mod:`.spec`, swap preemption,
    shedding, the dense fallback).
  * :mod:`.service` — :class:`InferenceImpl` ``infer`` and ``score_page``,
    the bodies of the page ``Infer`` and ``ScorePage`` handlers, called
    in process.
"""
from .engine import (ContinuousBatcher, Engine, PagedBatcher,  # noqa: F401
                     ServeConfig, ShedError)
from .ingest import DecodePlan, IngestResult, PageIngest, PlanCache  # noqa: F401
from .kv_cache import (BlockAllocator, CacheOOM, PagedKVCache,  # noqa: F401
                       PrefixCache, aligned_block_size, block_keys)
from .sampling import GREEDY, GenerationParams, SamplingParams  # noqa: F401
from .service import (InferenceImpl, decode_token_page,  # noqa: F401
                      encode_gen_page, encode_prompt_page)
from .spec import ngram_propose  # noqa: F401

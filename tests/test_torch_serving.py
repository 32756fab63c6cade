"""The port's serving path against the JAX package's, on the same weights.

* ``PageIngest`` columns are bit-identical to the JAX ``PageIngest`` (its
  reference and Pallas decodes) for a prompt page and for a struct with
  every wire dtype, at record counts that are not powers of two.
* ``PagedBatcher`` given the same prompts and ``ServeConfig`` emits the
  same greedy tokens as the JAX ``PagedBatcher``, with the same scheduler
  stats (prefix hits, copy-on-write copies, speculative acceptance,
  preemptions, ...), including a pool small enough to force preemption,
  and serves a request past the paged budget on the dense engine.
  Requests are queued before the worker sees any of them, so both
  schedulers make the same decisions.  A token split counts as a fault
  only where the JAX reference's top-2 logit margin exceeds ``MARGIN``
  (float32: the two packages' logits agree to ~1e-6).
* ``InferenceImpl.infer(page)["page"]`` equals, byte for byte, the JAX
  ``encode_gen_page`` of the JAX batcher's tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import pages as jpages
from repro.core import types as JT
from repro.serving import Engine as JaxEngine
from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving import PageIngest as JaxPageIngest
from repro.serving import PagedBatcher as JaxPagedBatcher
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.service import encode_gen_page as jax_encode_gen_page
from repro.serving.service import prompt_record_struct as jax_prompt_struct

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import fastwire, pages
from repro_torch.core import types as T
from repro_torch.core.rpc import RpcError, Status
from repro_torch.serving import (Engine, GenerationParams, InferenceImpl,
                                 PagedBatcher, PageIngest, ServeConfig,
                                 ShedError, decode_token_page,
                                 encode_prompt_page)
from repro_torch.serving.service import prompt_record_struct

MARGIN = 1e-4
SC = dict(cache_len=96, max_new_tokens=12, prefill_chunk=8)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    cfg = reduced_config(get_config("qwen2-1.5b"))
    jengine = JaxEngine(jcfg, JaxServeConfig(**SC))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jengine.params), device="cpu",
        dtype=torch.float32)
    engine = Engine(cfg, ServeConfig(**SC), params=params, device="cpu")
    return jengine, engine


# -- ingest -------------------------------------------------------------------

def _all_wire_structs(mod):
    P = mod.Prim
    fields = [("a", mod.FixedArray(P("uint32"), 3)),
              ("b", mod.FixedArray(P("int32"), 2)),
              ("c", mod.FixedArray(P("float32"), 2)),
              ("d", mod.FixedArray(P("uint16"), 3)),
              ("e", mod.FixedArray(P("bfloat16"), 2)),
              ("f", mod.FixedArray(P("float16"), 2)),
              ("g", mod.FixedArray(P("uint8"), 4)),
              ("h", P("bool")), ("i", P("byte")), ("j", P("int8"))]
    return mod.Struct("AllWire", [mod.Field(n, t) for n, t in fields])


@pytest.mark.parametrize("n", [1, 3, 300])
def test_ingest_every_wire_dtype_bit_identical(n):
    rng = np.random.default_rng(n)
    s, js = _all_wire_structs(T), _all_wire_structs(JT)
    recs = rng.integers(0, 256, (n, fastwire.static_dtype(s).itemsize),
                        dtype=np.uint8)
    page = pages.write_page(s.name, recs)
    assert page == jpages.write_page(js.name, recs)
    ing = PageIngest(device="cpu")
    ing.register(s)
    got = ing.admit(page).columns
    for impl in (None, "pallas"):
        jing = JaxPageIngest(impl=impl)
        jing.register(js)
        want = jing.admit(page).columns
        assert sorted(got) == sorted(want)
        for name in want:
            a, b = got[name].numpy(), np.asarray(want[name])
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=f"{impl} {name}")
    assert ing.stats["records"] == n


def test_ingest_prompt_page_and_rejections():
    toks = np.random.default_rng(0).integers(0, 2 ** 31, (3, 37))
    page = encode_prompt_page(toks)
    ing = PageIngest(device="cpu")
    ing.register(prompt_record_struct(37))
    jing = JaxPageIngest()
    jing.register(jax_prompt_struct(37))
    got = ing.admit(page).columns["tokens"].numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jing.admit(page).columns["tokens"]))
    np.testing.assert_array_equal(got, toks.astype(np.int32))
    bad = bytearray(page)
    bad[70] ^= 1
    with pytest.raises(pages.PageError, match="CRC"):
        ing.admit(bytes(bad))
    with pytest.raises(pages.PageError, match="no decode plan"):
        ing.admit(encode_prompt_page(toks[:, :5]))
    assert ing.stats["rejected"] == 2


# -- the paged batcher ----------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(5)
    system = rng.integers(0, 512, 16)
    rows = []
    for i, n in enumerate((5, 16, 23, 40, 9, 31, 16)):
        row = rng.integers(0, 512, n)
        if i in (1, 3, 6):
            row[:16] = system        # shared full block; #6 is block-aligned
        if i == 5:
            row = np.resize(rng.integers(0, 512, 3), n)   # drafter's case
        rows.append(row.astype(np.int32))
    return rows


def _run(batcher, requests):
    """Queue every request before the worker sees any, then wait."""
    with batcher._cond:
        futs = [batcher.submit(t, **kw) for t, kw in requests]
    return [f.result(timeout=300) for f in futs]


def _check_tokens(jengine, requests, got, want) -> int:
    """Equal tokens, or a split where the JAX reference's top-2 margin is
    within MARGIN (then the continuations legitimately differ).  Returns
    the number of splits."""
    splits = 0
    for (prompt, _), a, b in zip(requests, got, want):
        if np.array_equal(a, b):
            continue
        assert a.shape == b.shape
        for r in range(a.shape[0]):
            diff = np.nonzero(a[r] != b[r])[0]
            if diff.size == 0:
                continue
            j = int(diff[0])
            seq = np.concatenate([np.atleast_2d(prompt)[r], b[r, :j]])
            logits, _ = jengine.model.prefill(
                jengine.params, {"tokens": jnp.asarray(seq[None])},
                len(seq) + 1)
            top = np.sort(np.asarray(logits[0], np.float64))[-2:]
            assert top[1] - top[0] <= MARGIN, (r, j, top)
            splits += 1
    return splits


def test_paged_batcher_matches_jax_tokens_and_stats(engines):
    jengine, engine = engines
    reqs = [(p, {}) for p in _prompts()]
    reqs.append((np.stack([_prompts()[0], _prompts()[4][:5]]), {}))  # 2 rows
    reqs.append((_prompts()[2], {"stop_token": 7}))
    jb = JaxPagedBatcher(jengine, max_batch=6)
    pb = PagedBatcher(engine, max_batch=6)
    try:
        want = _run(jb, reqs)
        got = _run(pb, reqs)
        splits = _check_tokens(jengine, reqs, got, want)
        js, ps = jb.collect_stats(), pb.collect_stats()
    finally:
        jb.close()
        pb.close()
    if not splits:   # a legitimate split changes what follows it
        assert ps == js
    assert ps["prefix_hits"] > 0 and ps["cow_copies"] > 0
    assert ps["spec_accepted"] > 0 and ps["mixed_steps"] > 0


@pytest.mark.parametrize("fused", [True, False])
def test_paged_batcher_preemption_matches_jax(engines, fused):
    """A pool of 4 usable blocks: two priority-0 requests fill it, and a
    priority-1 request pages one of them out to host; it resumes later
    token-identically."""
    jengine, engine = engines
    sc = dict(cache_len=32, max_new_tokens=8, prefill_chunk=8, num_blocks=5,
              fused_prefill=fused)
    jeng = JaxEngine(jengine.cfg, JaxServeConfig(**sc), params=jengine.params)
    eng = Engine(engine.cfg, ServeConfig(**sc), params=engine.params,
                 device="cpu")
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 512, 12).astype(np.int32), {"priority": p})
            for p in (0, 0, 1)]
    jb, pb = JaxPagedBatcher(jeng, max_batch=4), PagedBatcher(eng,
                                                             max_batch=4)
    try:
        want = _run(jb, reqs)
        got = _run(pb, reqs)
        splits = _check_tokens(jeng, reqs, got, want)
        js, ps = jb.collect_stats(), pb.collect_stats()
    finally:
        jb.close()
        pb.close()
    if not splits:   # a legitimate split changes what follows it
        assert ps == js
    assert ps["preemptions"] >= 1 and ps["swap_ins"] >= 1


def test_deferred_features_raise_without_killing_the_worker(engines):
    """A sampled request (temperature 0.7) and ``n = 3`` candidates, which
    raised before the port had a sampler, give the JAX batcher's tokens;
    a request past the paged budget (90 + 30 tokens at cache_len 96: its
    decode writes clamp into the last cache slot, as in JAX) is served by
    the dense engine, with the JAX batcher's tokens and
    ``dense_fallbacks``; the worker survives all of it."""
    jengine, engine = engines
    pb = PagedBatcher(engine, max_batch=3)    # room for the n = 3 fork
    jb = JaxPagedBatcher(jengine, max_batch=3)
    try:
        prompt = np.arange(6, dtype=np.int32)
        got = pb.submit(prompt, params=GenerationParams(temperature=0.7)
                        ).result(timeout=120)
        want = jb.submit(prompt, params=JaxGenerationParams(temperature=0.7)
                         ).result(timeout=120)
        np.testing.assert_array_equal(got, want)
        got = pb.submit(prompt, n=3).result(timeout=120)
        want = jb.submit(prompt, n=3).result(timeout=120)
        assert got.shape == (3, SC["max_new_tokens"])
        np.testing.assert_array_equal(got, want)
        assert pb.stats["forks"] == jb.stats["forks"] == 2
        assert pb.stats["sampled_requests"] == jb.stats["sampled_requests"]
        big = np.random.default_rng(2).integers(0, 512, (1, 90)).astype(
            np.int32)
        got = pb.submit(big, max_new_tokens=30).result(timeout=120)
        want = jb.submit(big, max_new_tokens=30).result(timeout=120)
        assert got.shape == (1, 30)
        np.testing.assert_array_equal(got, want)
        assert pb.stats["dense_fallbacks"] == jb.stats["dense_fallbacks"] == 1
        assert pb.stats["shed"] == jb.stats["shed"] == 0
        out = pb.generate(prompt, max_new_tokens=3)
        assert out.shape == (1, 3)
        assert pb.stats["worker_errors"] == 0
    finally:
        pb.close()
        jb.close()


class _Expired:
    def expired(self):
        return True

    def remaining(self):
        return -1.0


def test_cancel_and_deadline_shed_and_return_blocks(engines):
    _, engine = engines
    pb = PagedBatcher(engine, max_batch=2)
    free = pb.cache.num_free_blocks
    try:
        with pb._cond:
            fut = pb.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
            assert pb.cancel(fut)
        with pytest.raises(ShedError, match="in queue"):
            fut.result(timeout=60)
        late = pb.submit(np.arange(6, dtype=np.int32), deadline=_Expired())
        with pytest.raises(ShedError, match="before admission"):
            late.result(timeout=60)
        assert pb.generate(np.arange(6, dtype=np.int32),
                           max_new_tokens=2).shape == (1, 2)
        assert pb.stats["cancelled"] == 1 and pb.stats["shed"] == 2
        pb.cache.prefix.evict(len(pb.cache.prefix))
        assert pb.cache.num_free_blocks == free
    finally:
        pb.close()


def test_serve_config_matches_jax_field_for_field():
    jf = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert jf == pf


# -- the page-level Infer handler -------------------------------------------------

def test_infer_page_bytes_match_jax(engines):
    jengine, engine = engines
    impl = InferenceImpl(engine)
    jb = JaxPagedBatcher(jengine, max_batch=4)
    try:
        for toks, maxn in ((_prompts()[3][None], 10),
                           (np.stack([_prompts()[0], _prompts()[0][::-1]]),
                            None)):
            res = impl.infer(encode_prompt_page(toks), max_new_tokens=maxn)
            want = jb.generate(toks, max_new_tokens=16 if maxn is None
                               else maxn)
            assert res["page"] == jax_encode_gen_page(want)
            assert (res["batch"], res["new_tokens"]) == want.shape
            np.testing.assert_array_equal(decode_token_page(res["page"]),
                                          want)
        res = impl.infer(encode_prompt_page(_prompts()[0][None]),
                         max_new_tokens=0)
        assert res == {"batch": 1, "new_tokens": 0, "page": b""}
        with pytest.raises(RpcError) as e:
            impl.infer(b"\x00" * 64)
        assert e.value.code == Status.INVALID_ARGUMENT
        with pytest.raises(RpcError) as e:
            impl.infer(encode_prompt_page(np.zeros((1, 200), np.int32)))
        assert e.value.code == Status.INVALID_ARGUMENT   # over cache_len
    finally:
        impl.close()
        jb.close()

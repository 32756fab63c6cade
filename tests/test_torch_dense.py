"""The port's dense serving path against the JAX package's, on the same
weights: qwen2-1.5b and recurrentgemma-9b at ``reduced_config`` (f32; the
hybrid has 2 super-blocks plus the tail and a window of 8).

* ``flash_attention_plain`` against the JAX flash kernel in interpret mode
  (at shapes it accepts) and against ``ref.attention`` (ragged ``Tq``/``S``,
  windows, ``q_offset``, non-causal, fully masked rows); ``rglru_scan_plain``
  against ``rglru_scan(interpret=True)`` and ``ref.rglru``.  Tolerance: the
  JAX kernel tests' float32 atol 3e-5 / rtol 1e-4.
* ``DecoderLM`` and ``HybridLM`` ``prefill``, ``decode_step`` (the ring
  cache wrapping past the window, the clamped write past ``cache_len``, a
  prompt longer than the window) and ``logits`` against JAX, at the same
  tolerance, caches included.
* ``Engine.generate`` and ``ContinuousBatcher`` tokens (bit-equal) and
  stats (equal), ``Engine.score`` (allclose), and
  ``InferenceImpl(paged=False)`` response page bytes and ``score_page``
  against the JAX counterparts; an oversized paged request is served by
  the dense engine in both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.kernels import rglru_scan as jrg
from repro.models import get_model as jax_get_model
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving import PagedBatcher as JaxPagedBatcher
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.service import encode_gen_page as jax_encode_gen_page

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.rpc import RpcError, Status
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import HybridLM, get_model
from repro_torch.serving import (ContinuousBatcher, Engine,
                                 GenerationParams, InferenceImpl,
                                 PagedBatcher, ServeConfig, decode_token_page,
                                 encode_prompt_page)

TOL = dict(atol=3e-5, rtol=1e-4)
ARCHS = ("qwen2-1.5b", "recurrentgemma-9b")
SC = dict(cache_len=32, max_new_tokens=6)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(JAX model, JAX params, port model, port params) on one set of
    weights, drawn by the JAX init."""
    jcfg = jax_reduced_config(jax_get_config(request.param))
    cfg = reduced_config(get_config(request.param))
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np_tree(jparams), device="cpu",
                               dtype=torch.float32)
    return jmodel, jparams, get_model(cfg), params


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    jcfg = jax_reduced_config(jax_get_config(request.param))
    cfg = reduced_config(get_config(request.param))
    jengine = JaxEngine(jcfg, JaxServeConfig(**SC))
    params = params_from_numpy(_np_tree(jengine.params), device="cpu",
                               dtype=torch.float32)
    engine = Engine(cfg, ServeConfig(**SC), params=params, device="cpu")
    return jengine, engine


# -- kernels' plain versions ------------------------------------------------------

def _qkv(seed, b, hq, hkv, tq, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,tq,s,d,causal,window,q_offset", [
    (4, 2, 16, 16, 16, True, None, 0),
    (4, 1, 16, 16, 16, True, 4, 0),        # MQA, sliding window
    (6, 2, 8, 24, 16, True, None, 16),     # g = 6, query offset
    (4, 2, 16, 24, 32, False, None, 0),    # non-causal
])
def test_flash_plain_matches_pallas(hq, hkv, tq, s, d, causal, window,
                                    q_offset):
    q, k, v = _qkv(tq * s, 2, hq, hkv, tq, s, d)
    got = fa.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             q_offset=q_offset).numpy()
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, block_q=8,
                               block_k=8, q_offset=q_offset, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("tq,s,causal,window,q_offset", [
    (7, 13, True, None, 6),       # ragged, offset
    (5, 9, False, None, 0),       # ragged, non-causal
    (11, 11, True, 3, 0),         # ragged, window
    (9, 20, False, 4, 5),         # window without causality
    (1, 1, True, None, 0),
    (4, 10, True, 8, 14),         # rows past every key's window
])
def test_flash_plain_matches_ref(tq, s, causal, window, q_offset):
    q, k, v = _qkv(tq + s, 2, 6, 2, tq, s, 16)
    got = fa.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             q_offset=q_offset).numpy()
    want = np.asarray(jref.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset))
    np.testing.assert_allclose(got, want, **TOL)
    if window is not None and causal:
        # a row whose window holds no key is exactly zero
        qpos = np.arange(tq) + q_offset
        empty = qpos - (s - 1) >= window
        assert not got[:, :, empty].any()


def test_flash_fully_masked_rows_are_zero():
    q, k, v = _qkv(1, 1, 4, 2, 4, 10, 16)
    got = fa.flash_attention(*_t(q, k, v), window=8, q_offset=14).numpy()
    assert not got[:, :, 3].any() and got[:, :, 0].any()   # qpos 17, 14


@pytest.mark.parametrize("b,t,d,chunk", [(1, 32, 16, 8), (2, 24, 32, 8)])
def test_rglru_plain_matches_pallas_and_ref(b, t, d, chunk):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d))))).astype(
        np.float32)
    h, hf = rg.rglru_scan(*_t(x, a))
    for jh, jf in (jrg.rglru_scan(jnp.asarray(x), jnp.asarray(a),
                                  chunk=chunk, interpret=True),
                   jref.rglru(jnp.asarray(x), jnp.asarray(a))):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(jf), **TOL)
    assert hf.dtype == torch.float32
    # ragged T (the TPU kernel needs a multiple of its chunk)
    h7, hf7 = rg.rglru_scan(*_t(x[:, :7], a[:, :7]))
    jh7, jf7 = jref.rglru(jnp.asarray(x[:, :7]), jnp.asarray(a[:, :7]))
    np.testing.assert_allclose(h7.numpy(), np.asarray(jh7), **TOL)
    np.testing.assert_allclose(hf7.numpy(), np.asarray(jf7), **TOL)


def test_ops_impl_switch_for_dense_kernels():
    q, k, v = _t(*_qkv(3, 1, 4, 2, 6, 6, 16))
    x, a = _t(*(np.random.default_rng(0).random((2, 1, 5, 8), np.float32)))
    torch.testing.assert_close(ops.attention(q, k, v, window=3),
                               ops.attention(q, k, v, window=3,
                                             impl="reference"))
    torch.testing.assert_close(ops.rglru(x, a), ops.rglru(x, a,
                                                          impl="reference"))
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.rglru(x, a, impl="pallas")


# -- models ------------------------------------------------------------------------

def _cache_close(got, want):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("t,cache_len,n_decode", [
    (5, 16, 10),   # hybrid: 8-slot ring cache, decode wraps past 8
    (12, 16, 4),   # hybrid: prompt longer than the window, T-long cache
    (3, 4, 6),     # clamped writes past cache_len (slot S-1)
])
def test_prefill_and_decode_match_jax(models, t, cache_len, n_decode):
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(t)
    toks = rng.integers(0, 512, (2, t)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                  cache_len)
    log, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _cache_close(cache, jcache)
    jdecode = jax.jit(jmodel.decode_step)
    for pos in range(t, t + n_decode):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                               jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(nxt), cache,
                                       pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"pos {pos}")
    _cache_close(cache, jcache)


def test_hybrid_config_copy_matches_jax_field_for_field():
    jf = dataclasses.asdict(jax_get_config("recurrentgemma-9b"))
    pf = dataclasses.asdict(get_config("recurrentgemma-9b"))
    assert (jf.pop("attention_impl"), pf.pop("attention_impl")) == \
        ("reference", "kernel")
    assert jf == pf


def test_init_cache_matches_jax(models):
    jmodel, _, model, _ = models
    want = jmodel.init_cache(2, 12)
    got = model.init_cache(2, 12, torch.device("cpu"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        assert not node.any()


def test_logits_match_jax(models):
    jmodel, jparams, model, params = models
    toks = np.random.default_rng(1).integers(0, 512, (2, 13)).astype(np.int32)
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_attention_path_matches_jax(models):
    """Long sequences under ``attention_impl="reference"`` take the
    query-chunked plain path in both packages (and, with a window, the
    sliced KV span)."""
    jmodel, jparams, model, params = models
    small = dict(attention_chunk_threshold=8, attention_q_chunk=4)
    jm = jax_get_model(dataclasses.replace(jmodel.cfg, **small))
    m = get_model(dataclasses.replace(model.cfg, attention_impl="reference",
                                      **small))
    toks = np.random.default_rng(2).integers(0, 512, (1, 16)).astype(np.int32)
    want = jm.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = m.logits(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the same numbers as the unchunked path
    np.testing.assert_allclose(
        got.numpy(), model.logits(params, {"tokens": torch.from_numpy(
            toks)}).numpy(), **TOL)


def test_reference_impl_equals_kernel_dispatch_on_cpu(models):
    """``attention_impl="reference"`` (every plain version by name, the
    RG-LRU scan included) and the default dispatch agree on CPU."""
    _, _, model, params = models
    ref = get_model(dataclasses.replace(model.cfg,
                                        attention_impl="reference"))
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 512, (2, 9)).astype(np.int32))
    a, _ = model.prefill(params, {"tokens": toks}, 12)
    b, _ = ref.prefill(params, {"tokens": toks}, 12)
    torch.testing.assert_close(a, b, **TOL)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_port_hybrid_init_tree_matches_bridged_jax_tree():
    """The port's own seeded init makes the JAX tree: same names, shapes
    and dtypes, ``lam`` float32 in a bfloat16 model."""
    jcfg = dataclasses.replace(
        jax_reduced_config(jax_get_config("recurrentgemma-9b")),
        dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    bridged = dict(_leaves(params_from_numpy(_np_tree(jparams), device="cpu",
                                             dtype=torch.bfloat16)))
    cfg = dataclasses.replace(reduced_config(get_config("recurrentgemma-9b")),
                              dtype="bfloat16")
    own = dict(_leaves(HybridLM(cfg).init(0, torch.device("cpu"))))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in bridged.items()}
    assert own["supers/b0/rec/lam"].dtype == torch.float32


# -- serving -----------------------------------------------------------------------

class _Never:
    def expired(self):
        return False

    def remaining(self):
        return 1e9


def test_engine_generate_and_score_match_jax(engines):
    jengine, engine = engines
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    # a stop token the greedy run first emits at output j >= 2
    full = jengine.generate(toks[:1], max_new_tokens=8)[0]
    j = next(j for j in range(2, 8) if full[j] not in full[:j])
    before = (dict(engine.stats), dict(jengine.stats))
    for kw in ({}, {"max_new_tokens": 9}, {"max_new_tokens": 0}):
        np.testing.assert_array_equal(engine.generate(toks, **kw),
                                      jengine.generate(toks, **kw))
    # the stop token and the deadline
    kw = dict(max_new_tokens=8, stop_token=int(full[j]), deadline=_Never())
    got = engine.generate(toks[:1], **kw)
    np.testing.assert_array_equal(got, jengine.generate(toks[:1], **kw))
    assert got.shape == (1, j)
    for key in engine.stats:
        assert engine.stats[key] - before[0][key] \
            == jengine.stats[key] - before[1][key], key
    got = engine.score(toks)
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_allclose(got, jengine.score(toks), **TOL)


def _requests():
    rng = np.random.default_rng(6)
    same = [rng.integers(0, 512, 10).astype(np.int32) for _ in range(3)]
    return [(same[0], {}),
            (rng.integers(0, 512, (2, 7)).astype(np.int32), {}),
            (same[1], {"max_new_tokens": 3}),
            (rng.integers(0, 512, 5).astype(np.int32), {"stop_token": 7}),
            (same[2], {})]


def _run(batcher, requests):
    """Queue every request before the worker sees any, then wait."""
    with batcher._cond:
        futs = [batcher.submit(t, **kw) for t, kw in requests]
    return [f.result(timeout=300) for f in futs]


def test_continuous_batcher_matches_jax_tokens_and_stats(engines):
    jengine, engine = engines
    reqs = _requests()
    jb, cb = JaxContinuousBatcher(jengine), ContinuousBatcher(engine)
    try:
        want = _run(jb, reqs)
        got = _run(cb, reqs)
        js, ps = jb.collect_stats(), cb.collect_stats()
    finally:
        jb.close()
        cb.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ps == js
    assert ps["batched_rows"] > ps["batches"]    # the three merged
    assert cb.mean_batch_rows() == jb.mean_batch_rows() > 1.0
    # a sampled request and n = 2 candidates (which raised before the port
    # had a sampler) run alone and give the JAX batcher's tokens
    sampled = [(reqs[0][0], {"params": GenerationParams(temperature=0.7)}),
               (reqs[0][0], {"params": GenerationParams(temperature=0.7,
                                                        seed=5, n=2)})]
    jb, cb = JaxContinuousBatcher(jengine), ContinuousBatcher(engine)
    try:
        want = _run(jb, [(t, {"params": JaxGenerationParams(
            temperature=0.7, seed=kw["params"].seed, n=kw["params"].n)})
            for t, kw in sampled])
        got = _run(cb, sampled)
        js, ps = jb.collect_stats(), cb.collect_stats()
    finally:
        jb.close()
        cb.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].shape[0] == 2
    assert ps == js and ps["sampled_requests"] == 2 and ps["batches"] == 2


def test_infer_and_score_page_match_jax(engines):
    jengine, engine = engines
    dense = Engine(engine.cfg, ServeConfig(paged=False, **SC),
                   params=engine.params, device="cpu")
    impl = InferenceImpl(dense)
    jb = JaxContinuousBatcher(jengine)
    try:
        assert isinstance(impl.batcher, ContinuousBatcher)
        toks = np.random.default_rng(7).integers(0, 512, (3, 9))
        res = impl.infer(encode_prompt_page(toks), max_new_tokens=5)
        want = jb.generate(toks.astype(np.int32), max_new_tokens=5)
        assert res["page"] == jax_encode_gen_page(want)
        assert (res["batch"], res["new_tokens"]) == want.shape
        np.testing.assert_array_equal(decode_token_page(res["page"]), want)
        scores = impl.score_page(encode_prompt_page(toks))["scores"]
        assert scores.dtype == np.float32
        np.testing.assert_allclose(scores,
                                   jengine.score(toks.astype(np.int32)),
                                   **TOL)
        with pytest.raises(RpcError) as e:
            impl.score_page(encode_prompt_page(toks[:, :1]))
        assert e.value.code == Status.INVALID_ARGUMENT
    finally:
        impl.close()
        jb.close()


def test_default_service_batcher_follows_the_model_family(engines):
    """The hybrid model has no paged KV: the default ServeConfig gives it
    the dense batcher, as in JAX; the dense decoder gets the paged one."""
    _, engine = engines
    impl = InferenceImpl(engine)
    try:
        want = ContinuousBatcher if engine.cfg.block_pattern \
            else PagedBatcher
        assert type(impl.batcher) is want
    finally:
        impl.close()


def test_paged_oversized_requests_run_dense_like_jax():
    """Too many rows, or prompt + generation past the block table: both
    packages serve the request on the dense engine, with the same tokens
    and the same stats (``dense_fallbacks``, not ``shed``)."""
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    sc = dict(cache_len=24, max_new_tokens=4, prefill_chunk=8)
    jengine = JaxEngine(jcfg, JaxServeConfig(**sc))
    engine = Engine(reduced_config(get_config("qwen2-1.5b")),
                    ServeConfig(**sc), device="cpu",
                    params=params_from_numpy(_np_tree(jengine.params),
                                             device="cpu",
                                             dtype=torch.float32))
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 512, (3, 6)).astype(np.int32), {}),   # rows
            (rng.integers(0, 512, 20).astype(np.int32),            # length
             {"max_new_tokens": 14}),
            (rng.integers(0, 512, 6).astype(np.int32), {})]
    jb = JaxPagedBatcher(jengine, max_batch=2)
    pb = PagedBatcher(engine, max_batch=2)
    try:
        want = _run(jb, reqs)
        got = _run(pb, reqs)
        js, ps = jb.collect_stats(), pb.collect_stats()
    finally:
        jb.close()
        pb.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ps == js
    assert ps["dense_fallbacks"] == 2 and ps["shed"] == 0

"""The port's rwkv6-7b serving path against the JAX package's, on the same
weights, at ``reduced_config`` (f32: 2 layers, d_model 64, 4 WKV heads of
16).

* ``rwkv6_scan_plain`` against the JAX WKV kernel in interpret mode at
  the JAX kernel tests' shapes, and against ``ref.rwkv6`` at ragged T
  (the TPU kernel needs a multiple of its chunk) and with an initial
  state carried across two halves; ``rwkv6_chunked_plain`` against
  ``ref.rwkv6_chunked``.  Tolerance: the JAX kernel tests' float32
  atol 3e-5 / rtol 1e-4, unless a test says otherwise.
* ``layer_norm`` and ``group_norm``; the config copied field for field;
  the port's init tree against the bridged JAX tree.
* ``DecoderLM`` logits, prefill state (``shift_t``, ``shift_c``,
  ``wkv``) and decode steps against JAX under both ``rwkv_impl`` values.
* ``Engine.generate`` / ``score``, ``ContinuousBatcher`` tokens and stats,
  and ``InferenceImpl.infer`` / ``score_page`` response pages against the
  JAX package: bit-equal for tokens and pages, allclose for scores.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as jrw
from repro.models import get_model as jax_get_model
from repro.models import layers as jlayers
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.service import encode_gen_page as jax_encode_gen_page

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import DecoderLM, get_model
from repro_torch.models import layers as L
from repro_torch.serving import (ContinuousBatcher, Engine, InferenceImpl,
                                 ServeConfig, decode_token_page,
                                 encode_prompt_page)

TOL = dict(atol=3e-5, rtol=1e-4)
ARCH = "rwkv6-7b"
SC = dict(cache_len=32, max_new_tokens=6)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _wkv_inputs(seed, b, h, t, kk, vv, scale=0.5):
    """The JAX kernel tests' inputs: N(0, scale^2) r, k, v; decays
    ``exp(-exp(N(0, 1)))``; u ~ N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, t, kk)).astype(np.float32) * scale
    k = rng.standard_normal((b, h, t, kk)).astype(np.float32) * scale
    v = rng.standard_normal((b, h, t, vv)).astype(np.float32) * scale
    w = np.exp(-np.exp(rng.standard_normal((b, h, t, kk)))).astype(
        np.float32)
    u = (rng.standard_normal((h, kk)) * 0.3).astype(np.float32)
    return r, k, v, w, u


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params) on one set of
    weights, drawn by the JAX init."""
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np_tree(jparams), device="cpu",
                               dtype=torch.float32)
    return jmodel, jparams, get_model(reduced_config(get_config(ARCH))), \
        params


@pytest.fixture(scope="module")
def engines():
    jengine = JaxEngine(jax_reduced_config(jax_get_config(ARCH)),
                        JaxServeConfig(**SC))
    params = params_from_numpy(_np_tree(jengine.params), device="cpu",
                               dtype=torch.float32)
    engine = Engine(reduced_config(get_config(ARCH)), ServeConfig(**SC),
                    params=params, device="cpu")
    return jengine, engine


# -- the WKV scan's plain versions --------------------------------------------

@pytest.mark.parametrize("b,h,t,kk,vv,chunk", [
    (1, 1, 32, 16, 16, 8),
    (2, 2, 64, 32, 32, 16),
    (1, 4, 128, 64, 64, 64),
])
def test_wkv_plain_matches_pallas_and_ref(b, h, t, kk, vv, chunk):
    r, k, v, w, u = _wkv_inputs(t + kk, b, h, t, kk, vv)
    o, s = rw.rwkv6_scan(*_t(r, k, v, w, u))
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    args = tuple(map(jnp.asarray, (r, k, v, w, u)))
    for jo, js in (jrw.rwkv6_scan(*args, chunk=chunk, interpret=True),
                   jref.rwkv6(*args)):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("t", [1, 7, 97, 200])
def test_wkv_plain_matches_ref_at_ragged_t(t):
    """Any T: the TPU kernel asserts ``T % min(128, T) == 0`` and so
    refuses 200 (a 200-token prompt); ``ref.rwkv6`` and the port take
    it."""
    r, k, v, w, u = _wkv_inputs(t, 2, 3, t, 16, 16)
    o, s = rw.rwkv6_scan(*_t(r, k, v, w, u))
    jo, js = jref.rwkv6(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    if t == 200:
        with pytest.raises(AssertionError):
            jrw.rwkv6_scan(*map(jnp.asarray, (r, k, v, w, u)),
                           interpret=True)


def test_wkv_plain_state_continuity():
    """Two halves with the state carried equal one scan, and the JAX
    reference with the same initial state."""
    r, k, v, w, u = _wkv_inputs(5, 1, 2, 64, 32, 32, scale=0.4)
    tr, tk, tv, tw, tu = _t(r, k, v, w, u)
    o_full, s_full = rw.rwkv6_scan_plain(tr, tk, tv, tw, tu)
    o1, s1 = rw.rwkv6_scan_plain(tr[:, :, :32], tk[:, :, :32],
                                 tv[:, :, :32], tw[:, :, :32], tu)
    o2, s2 = rw.rwkv6_scan_plain(tr[:, :, 32:], tk[:, :, 32:],
                                 tv[:, :, 32:], tw[:, :, 32:], tu,
                                 initial_state=s1)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **TOL)
    np.testing.assert_allclose(torch.cat([o1, o2], dim=2).numpy(),
                               o_full.numpy(), **TOL)
    jo2, js2 = jref.rwkv6(*(jnp.asarray(x[:, :, 32:]) for x in (r, k, v, w)),
                          jnp.asarray(u), initial_state=jnp.asarray(s1))
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo2), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **TOL)


@pytest.mark.parametrize("chunk,t", [(16, 128), (32, 128), (64, 128),
                                     (32, 8)])
def test_wkv_chunked_plain_matches_ref_chunked(chunk, t):
    """Decays over the JAX chunked test's range, ``exp(-exp(U(-6, 0.5)))``;
    a chunk longer than T is cut to T, as in JAX."""
    rng = np.random.default_rng(chunk + t)
    b, h, kk = 2, 2, 32
    r, k, v = (rng.standard_normal((b, h, t, kk)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, 0.5, (b, h, t, kk)))).astype(
        np.float32)
    u = (rng.standard_normal((h, kk)) * 0.3).astype(np.float32)
    s0 = rng.standard_normal((b, h, kk, kk)).astype(np.float32) * 0.1
    o, s = rw.rwkv6_chunked_plain(*_t(r, k, v, w, u), chunk=chunk,
                                  initial_state=torch.from_numpy(s0))
    jo, js = jref.rwkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                chunk=chunk, initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_wkv_chunked_plain_needs_a_multiple_of_the_chunk():
    r, k, v, w, u = _t(*_wkv_inputs(0, 1, 1, 40, 16, 16))
    with pytest.raises(ValueError, match="multiple"):
        rw.rwkv6_chunked_plain(r, k, v, w, u, chunk=32)


def test_ops_impl_switch_for_rwkv():
    args = _t(*_wkv_inputs(1, 1, 2, 9, 16, 16))
    for a, b in zip(ops.rwkv6(*args), ops.rwkv6(*args, impl="reference")):
        torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="impl"):
        ops.rwkv6(*args, impl="pallas")


# -- layers, config, params ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layer_norm_and_group_norm_match_jax(dtype):
    """float32 at the usual tolerance; bfloat16 within one bfloat16 ulp
    (both packages round a float32 result once, and the float32 results
    may differ in their last bit)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jx, js, jb = (jnp.asarray(a).astype(dtype) for a in (x, scale, bias))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tx, ts, tb = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (jx, js, jb))
    pairs = ((L.layer_norm(tx, ts, tb, 1e-5),
              jlayers.layer_norm(jx, js, jb, 1e-5)),
             (L.group_norm(tx, ts, tb, 4, 1e-5),
              jlayers.group_norm(jx, js, jb, 4, 1e-5)))
    for got, want in pairs:
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        if dtype == np.float32:
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                                       rtol=2 ** -7)


def test_rwkv_config_copy_matches_jax_field_for_field():
    jf = dataclasses.asdict(jax_get_config(ARCH))
    pf = dataclasses.asdict(get_config(ARCH))
    assert (jf.pop("attention_impl"), pf.pop("attention_impl")) == \
        ("reference", "kernel")
    assert jf == pf
    assert dataclasses.asdict(reduced_config(get_config(ARCH))) == \
        {**dataclasses.asdict(jax_reduced_config(jax_get_config(ARCH))),
         "attention_impl": "kernel"}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_port_rwkv_init_tree_matches_bridged_jax_tree():
    """The port's seeded init makes the JAX tree: the same names, shapes
    and dtypes.  Every leaf, ``u`` and ``w0`` included, is in the model
    dtype in JAX, and the bridge carries the tree across unchanged."""
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)),
                               dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    bridged = dict(_leaves(params_from_numpy(_np_tree(jparams), device="cpu",
                                             dtype=torch.bfloat16)))
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              dtype="bfloat16")
    own = dict(_leaves(DecoderLM(cfg).init(0, torch.device("cpu"))))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in bridged.items()}
    assert all(v.dtype == torch.bfloat16 for v in bridged.values())
    assert "lm_head" in own and "layers/u" in own
    for name, leaf in jleaves.items():
        assert str(leaf.dtype) == "bfloat16", name
        np.testing.assert_array_equal(bridged[name].float().numpy(),
                                      leaf.astype(np.float32), err_msg=name)
    assert bool((own["layers/w0"] == -6).all())


# -- the model ----------------------------------------------------------------

def _state_close(got, want):
    assert set(got) == set(want) == {"shift_t", "shift_c", "wkv"}
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf),
                                   **TOL, err_msg=name)


def _with_impl(models, rwkv_impl):
    jmodel, jparams, model, params = models
    kw = dict(rwkv_impl=rwkv_impl, rwkv_chunk=8)
    return (jax_get_model(dataclasses.replace(jmodel.cfg, **kw)), jparams,
            get_model(dataclasses.replace(model.cfg, **kw)), params)


@pytest.mark.parametrize("rwkv_impl,t,n_decode", [
    ("sequential", 16, 5), ("sequential", 1, 3), ("sequential", 13, 4),
    # the chunked form needs T to be a multiple of the chunk (8 here)
    ("chunked", 16, 5), ("chunked", 1, 3), ("chunked", 8, 4),
])
def test_prefill_and_decode_match_jax(models, rwkv_impl, t, n_decode):
    jmodel, jparams, model, params = _with_impl(models, rwkv_impl)
    rng = np.random.default_rng(t)
    toks = rng.integers(0, 512, (2, t)).astype(np.int32)
    jlog, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    log, state = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _state_close(state, jstate)
    jdecode = jax.jit(jmodel.decode_step)
    for pos in range(t, t + n_decode):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jlog, jstate = jdecode(jparams, jnp.asarray(nxt), jstate,
                               jnp.int32(pos))
        log, state = model.decode_step(params, torch.from_numpy(nxt), state,
                                       pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"pos {pos}")
    _state_close(state, jstate)


@pytest.mark.parametrize("rwkv_impl", ["sequential", "chunked"])
def test_logits_match_jax(models, rwkv_impl):
    jmodel, jparams, model, params = _with_impl(models, rwkv_impl)
    toks = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_cache_matches_jax(models):
    jmodel, _, model, _ = models
    want = jmodel.init_cache(3, 12)
    got = model.init_cache(3, 12, torch.device("cpu"))
    _state_close(got, want)
    assert not any(v.any() for v in got.values())


def test_reference_impl_equals_kernel_dispatch_on_cpu(models):
    """``attention_impl="reference"`` (the plain WKV scan by name) and the
    default dispatch agree on the CPU."""
    _, _, model, params = models
    ref = get_model(dataclasses.replace(model.cfg,
                                        attention_impl="reference"))
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 512, (2, 9)).astype(np.int32))
    a, sa = model.prefill(params, {"tokens": toks}, 12)
    b, sb = ref.prefill(params, {"tokens": toks}, 12)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    for name in sa:
        torch.testing.assert_close(sa[name], sb[name], atol=0, rtol=0)


def test_decode_continues_the_full_sequence(models):
    """Prefill of T tokens then one decode step gives the logits of the
    full T + 1 sequence (the recurrence is exact)."""
    _, _, model, params = models
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, 512, (1, 11)).astype(np.int32))
    full = model.logits(params, {"tokens": toks})[:, -1]
    _, state = model.prefill(params, {"tokens": toks[:, :10]}, 0)
    dec, _ = model.decode_step(params, toks[:, 10:], state, 10)
    torch.testing.assert_close(dec, full, **TOL)


# -- serving ------------------------------------------------------------------

def test_engine_generate_and_score_match_jax(engines):
    jengine, engine = engines
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    full = jengine.generate(toks[:1], max_new_tokens=8)[0]
    j = next(j for j in range(2, 8) if full[j] not in full[:j])
    before = (dict(engine.stats), dict(jengine.stats))
    for kw in ({}, {"max_new_tokens": 9}, {"max_new_tokens": 0}):
        np.testing.assert_array_equal(engine.generate(toks, **kw),
                                      jengine.generate(toks, **kw))
    kw = dict(max_new_tokens=8, stop_token=int(full[j]))
    got = engine.generate(toks[:1], **kw)
    np.testing.assert_array_equal(got, jengine.generate(toks[:1], **kw))
    assert got.shape == (1, j)
    for key in engine.stats:
        assert engine.stats[key] - before[0][key] \
            == jengine.stats[key] - before[1][key], key
    got = engine.score(toks)
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_allclose(got, jengine.score(toks), **TOL)


def _run(batcher, requests):
    """Queue every request before the worker sees any, then wait."""
    with batcher._cond:
        futs = [batcher.submit(t, **kw) for t, kw in requests]
    return [f.result(timeout=300) for f in futs]


def test_continuous_batcher_matches_jax_tokens_and_stats(engines):
    jengine, engine = engines
    rng = np.random.default_rng(6)
    same = [rng.integers(0, 512, 10).astype(np.int32) for _ in range(3)]
    reqs = [(same[0], {}),
            (rng.integers(0, 512, (2, 7)).astype(np.int32), {}),
            (same[1], {"max_new_tokens": 3}),
            (rng.integers(0, 512, 1).astype(np.int32), {}),
            (same[2], {})]
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


def test_infer_and_score_page_match_jax(engines):
    """The default ServeConfig asks for paging; RWKV has no paged KV, so
    the service takes the dense batcher, as in JAX."""
    jengine, engine = engines
    impl = InferenceImpl(engine)
    jb = JaxContinuousBatcher(jengine)
    try:
        assert type(impl.batcher) is ContinuousBatcher
        assert engine.serve.paged and not engine.supports_paged
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
    finally:
        impl.close()
        jb.close()

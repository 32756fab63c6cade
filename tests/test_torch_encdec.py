"""seamless-m4t-medium (the encoder-decoder) against the JAX package, on
``reduced_config`` in float32 with the JAX init's weights
(``params_from_numpy``), at the JAX kernel tests' atol 3e-5 / rtol 1e-4:

* ``EncDecLM`` ``encode`` (the memory), ``logits``, ``prefill`` (K/V and
  memory) and ``decode_step`` with seeded random frames: the served path
  attends over zero frames, whose memory is exactly zero, so only random
  frames show a fault in the encoder or the cross-attention;
* ``Engine.generate`` (bit-equal tokens) and ``Engine.score`` with the
  stub frontend's zero frames ``[B, max(T // 8, 1), D]``;
* an ``Infer`` page through ``InferenceImpl`` (the dense
  ``ContinuousBatcher``: no paged path in either package), page bytes
  equal to the JAX batcher's tokens, and ``score_page``;
* on the card, the flash kernel's head_dim 64 build against its plain
  version at the model's shapes (skipped without a card).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.service import encode_gen_page as jax_encode_gen_page

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import EncDecLM, get_model
from repro_torch.serving import (ContinuousBatcher, Engine, InferenceImpl,
                                 ServeConfig, decode_token_page,
                                 encode_prompt_page)

ARCH = "seamless-m4t-medium"
TOL = dict(atol=3e-5, rtol=1e-4)
SC = dict(cache_len=32, max_new_tokens=6)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params) on the JAX init's
    weights."""
    jmodel = jax_get_model(jax_reduced_config(jax_get_config(ARCH)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np_tree(jparams), device="cpu",
                               dtype=torch.float32)
    return jmodel, jparams, get_model(reduced_config(get_config(ARCH))), \
        params


@pytest.fixture(scope="module")
def engines(models):
    jmodel, jparams, model, params = models
    jengine = JaxEngine(jmodel.cfg, JaxServeConfig(**SC), params=jparams)
    return jengine, Engine(model.cfg, ServeConfig(**SC), params=params,
                           device="cpu")


def _batch(b, t, s, d, vocab, seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, s, d)).astype(np.float32),
            "tokens": rng.integers(0, vocab, (b, t)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_encode_and_logits_match_jax(models):
    jmodel, jparams, model, params = models
    assert isinstance(model, EncDecLM)
    batch = _batch(2, 11, 5, model.cfg.d_model, model.cfg.vocab_size, 1)
    want = jmodel.encode(jparams, jnp.asarray(batch["frames"]))
    got = model.encode(params, torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.abs().max()) > 0.1
    want = jmodel.logits(jparams, _jax(batch))
    got = model.logits(params, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_steps_match_jax(models):
    jmodel, jparams, model, params = models
    t, cache_len = 9, 16
    batch = _batch(2, t, 4, model.cfg.d_model, model.cfg.vocab_size, 2)
    jlog, jcache = jmodel.prefill(jparams, _jax(batch), cache_len)
    log, cache = model.prefill(params, _torch(batch), cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert set(cache) == set(jcache) == {"k", "v", "memory"}
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL,
                                   err_msg=name)
    rng = np.random.default_rng(3)
    for pos in range(t, t + 4):
        nxt = rng.integers(0, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(nxt), cache,
                                       pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"pos {pos}")


def test_init_cache_and_init_tree_match_jax(models):
    jmodel, jparams, model, _ = models
    want = jmodel.init_cache(3, 20)
    got = model.init_cache(3, 20, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    own = model.init(0, torch.device("cpu"))
    assert dict(_shapes(own)) == dict(_shapes(_np_tree(jparams)))


def _shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


def test_engine_generate_and_score_with_zero_frames_match_jax(engines):
    jengine, engine = engines
    toks = np.random.default_rng(4).integers(0, 512, (2, 19)) \
        .astype(np.int32)
    for kw in ({}, {"max_new_tokens": 9}):
        np.testing.assert_array_equal(engine.generate(toks, **kw),
                                      jengine.generate(toks, **kw))
    got = engine.score(toks)
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_allclose(got, jengine.score(toks), **TOL)
    # the stub frontend's frames: zeros, T // frame_ratio of them
    batch = engine._prefill_batch(toks)
    assert tuple(batch["frames"].shape) == (2, 19 // 8, engine.cfg.d_model)
    assert not batch["frames"].any()


def test_infer_page_and_score_page_match_jax(engines):
    jengine, engine = engines
    assert not getattr(jax_get_model(jengine.cfg), "supports_paged", False)
    impl = InferenceImpl(engine)
    jb = JaxContinuousBatcher(jengine)
    try:
        assert isinstance(impl.batcher, ContinuousBatcher)
        toks = np.random.default_rng(7).integers(0, 512, (3, 17))
        res = impl.infer(encode_prompt_page(toks), max_new_tokens=5)
        want = jb.generate(toks.astype(np.int32), max_new_tokens=5)
        assert res["page"] == jax_encode_gen_page(want)
        np.testing.assert_array_equal(decode_token_page(res["page"]), want)
        scores = impl.score_page(encode_prompt_page(toks))["scores"]
        np.testing.assert_allclose(scores,
                                   jengine.score(toks.astype(np.int32)),
                                   **TOL)
    finally:
        impl.close()
        jb.close()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 3e-5, 1e-4),
    (torch.bfloat16, 2e-2, 2e-2),
])
@pytest.mark.parametrize("tq,s,causal", [
    (400, 400, True),      # the decoder's prefill
    (400, 50, False),      # cross-attention over 50 frames
    (1, 50, False),        # cross-attention in a decode step
    (50, 50, False),       # the encoder
    (65, 129, True),       # off the 64-row and 64-key tile grid
])
def test_cuda_flash_kernel_at_head_dim_64(cuda, dtype, atol, rtol, tq, s,
                                         causal):
    rng = np.random.default_rng(tq + s)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 16, n, 64)).astype(np.float32)).to(cuda).to(dtype)
        for n in (tq, s, s))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)

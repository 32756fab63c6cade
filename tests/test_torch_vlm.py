"""qwen2-vl-2b (M-RoPE, embedding inputs) against the JAX package, on
``reduced_config`` in float32 with the JAX init's weights
(``params_from_numpy``), at the JAX kernel tests' atol 3e-5 / rtol 1e-4:

* ``apply_mrope`` against JAX's, at the reduced sections (2, 3, 3) with
  positions that differ by axis (``tests/test_models.py:202``: an all-zero
  t axis leaves the first section unrotated) and at the full width's
  (16, 24, 24) over head_dim 128;
* ``DecoderLM`` ``forward`` / ``logits`` / ``prefill`` / ``decode_step``
  from ``embeds`` and ``[3, B, T]`` positions (decode steps embed token
  ids and rotate every axis by the step's position, as JAX does), and
  ``logits`` of the same stack fed token ids (positions 0..T-1 on all
  three axes);
* ``Engine.generate`` raises as JAX's does (neither package serves
  embedding inputs), and the family has no paged path in either.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.models.layers import apply_mrope as jax_apply_mrope
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import get_model
from repro_torch.models.layers import apply_mrope
from repro_torch.serving import Engine, ServeConfig

ARCH = "qwen2-vl-2b"
TOL = dict(atol=3e-5, rtol=1e-4)


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


def _mrope_positions(b, t, seed):
    """[3, B, T] positions as a VLM prompt lays them out: text tokens at
    t = h = w, then a patch grid at one t with h and w its row and
    column."""
    rng = np.random.default_rng(seed)
    n_text = t // 2
    side = t - n_text
    pos = np.zeros((3, b, t), np.int32)
    pos[:, :, :n_text] = np.arange(n_text)
    pos[0, :, n_text:] = n_text
    pos[1, :, n_text:] = n_text + np.arange(side) // 3
    pos[2, :, n_text:] = n_text + np.arange(side) % 3
    return pos + rng.integers(0, 3, (1, b, 1)).astype(np.int32)


@pytest.mark.parametrize("hd,sections,theta", [
    (16, (2, 3, 3), 10000.0),
    (128, (16, 24, 24), 1_000_000.0),
])
def test_apply_mrope_matches_jax(hd, sections, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 3, 7, hd)).astype(np.float32)
    p3 = _mrope_positions(2, 7, hd)
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(p3), theta, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), theta,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_mrope_sections_rotate_by_their_own_axis():
    """tests/test_models.py:202 on the port, against JAX too."""
    x = np.random.default_rng(0).standard_normal((1, 1, 4, 16)) \
        .astype(np.float32)
    p3 = np.stack([np.zeros((1, 4)), np.arange(4)[None],
                   2 * np.arange(4)[None]]).astype(np.int32)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 10000.0,
                      (2, 3, 3)).numpy()
    np.testing.assert_allclose(got[..., :2], x[..., :2], atol=1e-5)
    assert not np.allclose(got[..., 2:8], x[..., 2:8])
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(p3), 10000.0,
                           (2, 3, 3))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 10000.0,
                    (2, 3, 2))


def _embeds(b, t, d, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, t, d)).astype(np.float32),
            "positions": _mrope_positions(b, t, seed)}


def test_forward_and_logits_from_embeddings_match_jax(models):
    jmodel, jparams, model, params = models
    batch = _embeds(2, 12, model.cfg.d_model, 1)
    jx, jaux = jmodel.forward(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    x, aux = model.forward(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    assert float(aux) == float(jaux) == 0.0
    want = jmodel.logits(jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    got = model.logits(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_steps_from_embeddings_match_jax(models):
    jmodel, jparams, model, params = models
    t = 10
    batch = _embeds(2, t, model.cfg.d_model, 2)
    jlog, jcache = jmodel.prefill(jparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()}, 16)
    log, cache = model.prefill(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, 16)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    rng = np.random.default_rng(3)
    for pos in range(t, t + 4):
        nxt = rng.integers(0, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(nxt), cache,
                                       pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"pos {pos}")


def test_logits_from_tokens_match_jax(models):
    """The M-RoPE stack fed token ids (``input_kind="tokens"``): positions
    0..T-1 on every axis, in both packages."""
    jmodel, jparams, model, params = models
    jmodel = jax_get_model(dataclasses.replace(jmodel.cfg,
                                               input_kind="tokens"))
    model = get_model(dataclasses.replace(model.cfg, input_kind="tokens"))
    toks = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (2, 9)).astype(np.int32)
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_engine_refuses_embedding_inputs_like_jax(models):
    _, jparams, model, params = models
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    jengine = JaxEngine(jcfg, JaxServeConfig(cache_len=32), params=jparams)
    engine = Engine(model.cfg, ServeConfig(cache_len=32), params=params,
                    device="cpu")
    toks = np.zeros((1, 5), np.int32)
    with pytest.raises(NotImplementedError) as want:
        jengine.generate(toks, max_new_tokens=2)
    with pytest.raises(NotImplementedError) as got:
        engine.generate(toks, max_new_tokens=2)
    assert str(got.value) == str(want.value)
    # M-RoPE keeps the dense path in both packages
    assert not jax_get_model(jcfg).supports_paged
    assert not engine.supports_paged

"""The three dense decoder configs the port adds, against the JAX package.

gemma-2b (GeGLU, MQA, head_dim 256, the tied embedding scaled by √d),
yi-34b (GQA, untied unembed, rope_theta 5e6) and qwen2-72b (GQA, QKV
bias, untied):

* each port config equals the JAX one field for field at full width
  (``attention_impl`` aside: the port's documented departure), and so do
  the MoE, VLM and encoder-decoder configs (qwen2-moe-a2.7b,
  granite-moe-1b-a400m, qwen2-vl-2b, seamless-m4t-medium), whose models
  ``tests/test_torch_moe.py``, ``test_torch_vlm.py`` and
  ``test_torch_encdec.py`` hold; the port registers every JAX config, and
  each model takes the paged path in the port exactly where it does in
  JAX;
* on ``reduced_config`` in float32, with the JAX init's weights
  (``params_from_numpy``), the port's ``DecoderLM`` gives the JAX logits at
  the JAX kernel tests' atol 3e-5 / rtol 1e-4 through the paged steps (a
  prefill chunk, a mixed step, a decode step, a speculative verify step;
  pools too) and the dense ones (prefill, decode steps, ``logits``);
* greedy tokens through the ``PagedBatcher`` (prefix hits, copy on write,
  spec decode, mixed steps) and the ``ContinuousBatcher`` equal the JAX
  batchers' token for token, and so do their counters.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import PagedBatcher as JaxPagedBatcher
from repro.serving import ServeConfig as JaxServeConfig

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import get_model
from repro_torch.serving import (ContinuousBatcher, Engine, PagedBatcher,
                                 ServeConfig)

ARCHS = ("gemma-2b", "yi-34b", "qwen2-72b")
#: the other families' configs, held field for field here
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m", "qwen2-vl-2b",
                "seamless-m4t-medium")
TOL = dict(atol=3e-5, rtol=1e-4)
B, M, BS = 4, 4, 8          # rows, table width, block size
SC = dict(cache_len=64, max_new_tokens=6, block_size=8, prefill_chunk=8)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(JAX model, JAX params, port model, port params) on the JAX init's
    weights."""
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


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_config_copy_matches_jax_field_for_field(arch):
    jf = dataclasses.asdict(jax_get_config(arch))
    pf = dataclasses.asdict(get_config(arch))
    assert (jf.pop("attention_impl"), pf.pop("attention_impl")) == \
        ("reference", "kernel")
    assert jf == pf
    assert arch in ARCH_IDS
    assert [a for a in JAX_ARCH_IDS if a in ARCH_IDS] == ARCH_IDS


def test_port_registers_every_jax_config():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_supports_paged_matches_jax(arch, reduced):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jax_reduced_config(jcfg), reduced_config(cfg)
    assert getattr(get_model(cfg), "supports_paged", False) == \
        getattr(jax_get_model(jcfg), "supports_paged", False)


def _steps(rng, vocab):
    """(kind, tokens, positions, last_idx): a prefill chunk, a mixed step
    (prefill rows, decode rows padded to the chunk width), a decode step
    and a verify step of width 5."""
    c = 8
    pre = rng.integers(0, vocab, (B, c)).astype(np.int32)
    pos0 = np.broadcast_to(np.arange(c, dtype=np.int32), (B, c)).copy()
    last0 = np.array([7, 7, 4, 0], np.int32)
    adv = last0 + 1
    mix = rng.integers(0, vocab, (B, c)).astype(np.int32)
    last1 = np.array([7, 7, 0, 0], np.int32)
    pos1 = adv[:, None] + np.minimum(np.arange(c), last1[:, None])
    adv = adv + last1 + 1
    dec = rng.integers(0, vocab, (B, 1)).astype(np.int32)
    pos2 = adv[:, None].astype(np.int32)
    adv = adv + 1
    ver = rng.integers(0, vocab, (B, 5)).astype(np.int32)
    last3 = np.array([4, 2, 4, 0], np.int32)
    pos3 = adv[:, None] + np.minimum(np.arange(5), last3[:, None])
    return [("step", pre, pos0, last0),
            ("step", mix, pos1.astype(np.int32), last1),
            ("step", dec, pos2, np.zeros(B, np.int32)),
            ("verify", ver, pos3.astype(np.int32), last3)]


def test_paged_steps_match_jax(models):
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(0)
    tables = (np.arange(B * M, dtype=np.int32).reshape(B, M) + 1)
    jpool = jmodel.init_paged_pool(B * M + 1, BS)
    pool = model.init_paged_pool(B * M + 1, BS, torch.device("cpu"))
    for kind, toks, pos, last in _steps(rng, model.cfg.vocab_size):
        jfn, fn = (jmodel.paged_step, model.paged_step) if kind == "step" \
            else (jmodel.paged_step_verify, model.paged_step_verify)
        jlog, jpool = jfn(jparams, jnp.asarray(toks), jpool,
                          jnp.asarray(tables), jnp.asarray(pos),
                          jnp.asarray(last))
        log, pool = fn(params, torch.from_numpy(toks), pool,
                       *(torch.from_numpy(a) for a in (tables, pos, last)))
        want = np.asarray(jlog)
        if kind == "verify":
            for r in range(B):   # positions past last_idx are padding
                np.testing.assert_allclose(log.numpy()[r, :last[r] + 1],
                                           want[r, :last[r] + 1], **TOL)
        else:
            np.testing.assert_allclose(log.numpy(), want, **TOL)
        for name in ("k", "v"):   # block 0 takes padding in any order
            np.testing.assert_allclose(pool[name].numpy()[:, 1:],
                                       np.asarray(jpool[name])[:, 1:], **TOL)


def test_dense_prefill_decode_and_logits_match_jax(models):
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 11)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    log, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    for pos in range(11, 15):
        nxt = rng.integers(0, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(nxt), cache,
                                       pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"pos {pos}")
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prompts():
    """Mixed lengths; three share a 16-token system prompt (prefix hits;
    the last is the prompt itself, block-aligned: copy on write), one
    repeats a motif (drafts)."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, 512, 16)
    rows = []
    for i, n in enumerate((5, 23, 40, 9, 31, 16)):
        row = rng.integers(0, 512, n)
        if i in (1, 2, 5):
            row[:16] = system
        if i == 3:
            row = np.resize(rng.integers(0, 512, 3), n)
        rows.append(row.astype(np.int32))
    return rows


def _run(batcher, requests):
    """Queue every request before the worker sees any, then wait."""
    with batcher._cond:
        futs = [batcher.submit(t, **kw) for t, kw in requests]
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_batcher_tokens_and_stats_match_jax(engines, kind):
    jengine, engine = engines
    reqs = [(p, {}) for p in _prompts()]
    if kind == "paged":
        # three rows at a time: later prompts find earlier ones' prefixes
        jb = JaxPagedBatcher(jengine, max_batch=3)
        pb = PagedBatcher(engine, max_batch=3)
    else:
        reqs += [(p[:12], {}) for p in _prompts()[3:]]   # one length: merge
        jb, pb = JaxContinuousBatcher(jengine), ContinuousBatcher(engine)
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
    if kind == "paged":
        assert ps["prefix_hits"] > 0 and ps["cow_copies"] > 0
        assert ps["spec_steps"] > 0 and ps["mixed_steps"] > 0
    else:
        assert ps["batched_rows"] > ps["batches"]

"""The MoE decoders (qwen2-moe-a2.7b, granite-moe-1b-a400m) against the JAX
package, on ``reduced_config`` in float32 with the JAX init's weights
(``params_from_numpy``):

* ``moe_ffn``, grouped and global dispatch, against ``repro.models.moe``:
  outputs at the JAX kernel tests' atol 3e-5 / rtol 1e-4, the aux loss at
  1e-6, expert ids and drops bit-equal (and ``dispatch`` of the router's
  own routes is ``moe_ffn`` bit for bit); the smallest gap between adjacent
  router probabilities among each token's top k + 1 is held above 1e-4, so
  a near-tie (where summation order could flip a choice) fails loudly
  instead of passing by luck; a forced-drop case at capacity factor 0.25;
* the paged steps (a prefill chunk, a mixed step, a decode step and a
  verify step of width 5, where an expert has 3 slots a row for 10
  choices), pools too,
  against JAX ``paged_step`` / ``paged_step_verify``;
* greedy tokens and counters through the ``PagedBatcher`` (spec decode
  on) and the ``ContinuousBatcher``, equal to the JAX batchers' (at a
  vocabulary of 64, where greedy continuations repeat bigrams and the
  n-gram drafter proposes, so verify steps run);
* the router stays float32 through the bridge and the port's own init at
  bfloat16, and the port's init tree is the JAX tree.
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
from repro.models import moe as jmoe
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import PagedBatcher as JaxPagedBatcher
from repro.serving import ServeConfig as JaxServeConfig

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import DecoderLM, get_model
from repro_torch.models import moe as M
from repro_torch.serving import (ContinuousBatcher, Engine, PagedBatcher,
                                 ServeConfig)

ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
TOL = dict(atol=3e-5, rtol=1e-4)
B, M_BLOCKS, BS = 4, 4, 8          # rows, table width, block size
SC = dict(cache_len=64, max_new_tokens=6, block_size=8, prefill_chunk=8)
MIN_GAP = 1e-4
#: the batchers' vocabulary: small enough that greedy text repeats bigrams
VOCAB = 64


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _cfgs(arch, vocab=None, **moe):
    jcfg = jax_reduced_config(jax_get_config(arch))
    cfg = reduced_config(get_config(arch))
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    if moe:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(JAX model, JAX params, port model, port params) on the JAX init's
    weights."""
    jcfg, cfg = _cfgs(request.param)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np_tree(jparams), device="cpu",
                               dtype=torch.float32)
    return jmodel, jparams, get_model(cfg), params


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    jcfg, cfg = _cfgs(request.param, VOCAB)
    jengine = JaxEngine(jcfg, JaxServeConfig(**SC))
    params = params_from_numpy(_np_tree(jengine.params), device="cpu",
                               dtype=torch.float32)
    return jengine, Engine(cfg, ServeConfig(**SC), params=params,
                           device="cpu")


# -- the MoE FFN -------------------------------------------------------------


def _jax_routing(p, x, cfg, grouped):
    """The expert ids and the keep mask of ``repro/models/moe.py``, by its
    own lines: top-k of the float32 router's softmax, then the position
    cumulative sum (per row, or over every token)."""
    m = cfg.moe
    logits = jnp.asarray(x) @ p["router"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    b, t, _ = x.shape
    flat = idx.reshape(b, t * m.top_k) if grouped else idx.reshape(1, -1)
    cap = int(max(1, round(flat.shape[1] * m.capacity_factor
                           / m.num_experts)))
    onehot = jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < cap).reshape(-1)


def _min_gap(probs, k):
    """Smallest gap between adjacent sorted probabilities among each
    token's top k + 1: the margin of every choice and of its order."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return float((top[..., :-1] - top[..., 1:]).min())


@pytest.mark.parametrize("arch,dispatch,moe", [
    ("qwen2-moe-a2.7b", "grouped", {}),
    ("qwen2-moe-a2.7b", "global", {}),
    ("granite-moe-1b-a400m", "grouped", {}),
    ("granite-moe-1b-a400m", "global", {}),
    # capacity factor 0.25 forces drops (tests/test_models.py:188)
    ("granite-moe-1b-a400m", "grouped", {"capacity_factor": 0.25}),
    ("granite-moe-1b-a400m", "global", {"capacity_factor": 0.25}),
])
def test_moe_ffn_matches_jax(arch, dispatch, moe):
    jcfg, cfg = _cfgs(arch, **moe)
    jcfg = dataclasses.replace(jcfg, moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    p = params_from_numpy(_np_tree(jp), device="cpu", dtype=torch.float32)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = M.moe_ffn(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=0)
    # routing: expert ids and drops bit-equal, no near-tie
    probs, _, idx = M.route(p, torch.from_numpy(x), cfg)
    assert _min_gap(probs, cfg.moe.top_k) > MIN_GAP
    want_idx, want_keep = _jax_routing(jp, x, jcfg, dispatch == "grouped")
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    n = x.shape[1] if dispatch == "grouped" else x.shape[0] * x.shape[1]
    flat = idx.reshape(2, -1) if dispatch == "grouped" else idx.reshape(1, -1)
    _, keep = M._slots(flat, cfg.moe.num_experts, M.capacity(n, cfg))
    np.testing.assert_array_equal(keep.reshape(-1).numpy(), want_keep)
    if moe:
        assert not want_keep.all()      # the forced-drop case drops


def test_capacity_rounds_halves_to_even_as_python():
    cfg = get_config("qwen2-moe-a2.7b")      # E 60, top-4, cf 1.25
    assert [M.capacity(w, cfg) for w in (32, 5, 1)] == [3, 1, 1]
    # 12 * 4 * 1.25 / 60 = 1.0; 36 -> 3.0; 18 -> 1.5 rounds to 2, 30 -> 2.5
    # rounds to 2: halves to even, as Python's round (floor(x + 0.5) gives 3)
    assert [M.capacity(w, cfg) for w in (12, 36, 18, 30)] == [1, 3, 2, 2]


# -- the paged steps and the dense path --------------------------------------


def _steps(rng, vocab):
    """(kind, tokens, positions, last_idx): a prefill chunk, a mixed step,
    a decode step and a verify step of width 5."""
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
    tables = (np.arange(B * M_BLOCKS, dtype=np.int32).reshape(B, M_BLOCKS)
              + 1)
    jpool = jmodel.init_paged_pool(B * M_BLOCKS + 1, BS)
    pool = model.init_paged_pool(B * M_BLOCKS + 1, BS, torch.device("cpu"))
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


def test_dense_prefill_decode_logits_and_aux_match_jax(models):
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 11)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    log, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    for pos in range(11, 14):
        nxt = rng.integers(0, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(nxt), cache,
                                       pos)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"pos {pos}")
    jx, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    x, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        model.logits(params, {"tokens": torch.from_numpy(toks)}).numpy(),
        np.asarray(jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})),
        **TOL)


# -- the batchers --------------------------------------------------------------


def _prompts():
    """Mixed lengths; three share a 16-token system prompt (prefix hits;
    the last is the prompt itself, block-aligned: copy on write), one
    repeats a motif (drafts, so verify steps of width 5)."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, VOCAB, 16)
    rows = []
    for i, n in enumerate((5, 23, 40, 9, 31, 16)):
        row = rng.integers(0, VOCAB, n)
        if i in (1, 2, 5):
            row[:16] = system
        if i == 3:
            row = np.resize(rng.integers(0, VOCAB, 3), n)
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
    assert engine.serve.spec_decode and engine.serve.spec_len == 4
    reqs = [(p, {}) for p in _prompts()]
    if kind == "paged":
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


# -- the two repaired faults -----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_router_stays_float32_through_the_bridge_and_init(arch):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    assert jparams["layers"]["moe"]["router"].dtype == jnp.float32
    bridged = params_from_numpy(_np_tree(jparams), device="cpu",
                                dtype=torch.bfloat16)
    layer = bridged["layers"]["moe"]
    assert layer["router"].dtype == torch.float32
    assert layer["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(layer["router"].numpy(),
                                  np.asarray(jparams["layers"]["moe"]
                                             ["router"]))
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="bfloat16")
    own = DecoderLM(cfg).init(0, torch.device("cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(own)} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(jparams)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serves_on_the_paged_path_in_both_packages(arch):
    jcfg, cfg = _cfgs(arch)
    assert jax_get_model(jcfg).supports_paged
    assert get_model(cfg).supports_paged
    engine = Engine(cfg, ServeConfig(**SC), device="cpu")
    assert engine.supports_paged

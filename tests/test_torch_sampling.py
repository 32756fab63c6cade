"""The port's seeded sampler and its engines against the JAX package's.

* **The key schedule.**  The port computes ``jax.random``'s threefry2x32
  uniforms in numpy; its ``_uniform_window`` equals a live call of the JAX
  ``_uniform_window`` bit for bit (compared as uint32 views), for seeds at
  both ends of the uint32 range, two windows and one to four candidates.
* **The sampler.**  ``_host_probs``, ``sample_tokens``, ``target_probs``,
  ``spec_uniforms`` and ``rejection_sample`` give the JAX functions' exact
  results on the same logits, and the oracle properties of the JAX tests
  (support, marginal, point mass) hold for the port alone.
* **The engines.**  On ``reduced_config`` qwen2-1.5b in float32 with the
  JAX model's weights, sampled tokens, ``n = 3`` fork candidates, a
  per-candidate stop and rejection-sampled speculative decode equal the
  JAX batchers' exactly, with equal ``forks``, ``spec_resamples`` and
  ``sampled_requests``; ``Engine.generate`` resumes from ``start_from``
  and reports each token to ``on_token``; ``PageIngest.admit_stream``
  resumes a page stream from a record cursor.
"""
import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import pages as jpages
from repro.serving import ContinuousBatcher as JaxContinuousBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import PageIngest as JaxPageIngest
from repro.serving import PagedBatcher as JaxPagedBatcher
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import sampling as jsampling
from repro.serving.service import prompt_record_struct as jax_prompt_struct

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import pages
from repro_torch.serving import (ContinuousBatcher, Engine, PagedBatcher,
                                 PageIngest, SamplingParams, ServeConfig)
from repro_torch.serving import sampling
from repro_torch.serving.service import prompt_record_struct

SC = dict(cache_len=96, max_new_tokens=12, prefill_chunk=8)
SAMPLED = [dict(temperature=0.8, top_k=40, seed=7),
           dict(temperature=1.0, top_p=0.9, seed=3),
           dict(temperature=0.7, top_k=5, top_p=0.8, seed=2 ** 32 - 1)]


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


def _pair(**kw):
    """The same SamplingParams in both packages."""
    return JaxSamplingParams(**kw), SamplingParams(**kw)


# -- the key schedule -------------------------------------------------------------

@pytest.mark.parametrize("cands", [1, 2, 3, 4])
@pytest.mark.parametrize("base", [0, 64])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 2 ** 32 - 1])
def test_uniform_window_bit_identical_to_jax(seed, base, cands):
    want = jsampling._uniform_window(seed, base, cands)
    got = sampling._uniform_window(seed, base, cands)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (cands, sampling._WINDOW, 2)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_uniform_at_across_the_window_boundary(seed):
    for index in range(60, 68):
        for cand0, rows in ((0, 1), (1, 3)):
            want = jsampling._uniform_at(seed, index, rows, cand0)
            got = sampling._uniform_at(seed, index, rows, cand0)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
    u = sampling.spec_uniforms(SamplingParams(temperature=1.0, seed=seed),
                               base_index=60, rows=2, width=8)
    assert ((0 <= u) & (u < 1)).all()


# -- the sampler on the same logits -------------------------------------------

@pytest.mark.parametrize("kw", SAMPLED + [dict(temperature=0.0)])
def test_sampler_functions_equal_jax(kw):
    jp, pp = _pair(**kw)
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 512)) * 2).astype(np.float32)
    if not pp.greedy:
        np.testing.assert_array_equal(sampling._host_probs(logits, pp),
                                      jsampling._host_probs(logits, jp))
    for index in (0, 5, 63, 64, 130):
        np.testing.assert_array_equal(
            sampling.sample_tokens(logits, pp, index=index),
            jsampling.sample_tokens(logits, jp, index=index))
    if pp.greedy:
        return
    l3 = (rng.normal(size=(2, 4, 512)) * 2).astype(np.float32)
    probs = sampling.target_probs(l3, pp)
    np.testing.assert_array_equal(probs, jsampling.target_probs(l3, jp))
    u = sampling.spec_uniforms(pp, base_index=61, rows=2, width=4)
    np.testing.assert_array_equal(
        u, jsampling.spec_uniforms(jp, base_index=61, rows=2, width=4))
    for r in range(2):
        draft = np.argsort(-probs[r, :3], axis=-1)[:, r]   # likely, or not
        assert sampling.rejection_sample(probs[r], draft, u[r, :, 0],
                                         u[r, :, 1]) \
            == jsampling.rejection_sample(probs[r], draft, u[r, :, 0],
                                          u[r, :, 1])


def test_sampling_params_validation_and_schedule_purity():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert SamplingParams().greedy and not SamplingParams(
        temperature=0.5).greedy
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=42)
    logits = np.random.default_rng(2).normal(size=(1, 256)).astype(
        np.float32)
    a = [int(sampling.sample_tokens(logits, sp, index=i)[0])
         for i in range(20)]
    assert a == [int(sampling.sample_tokens(logits, sp, index=i)[0])
                 for i in range(20)]
    assert len(set(a)) > 1
    assert a != [int(sampling.sample_tokens(logits, SamplingParams(
        temperature=0.8, top_p=0.9, seed=43), index=i)[0])
        for i in range(20)]
    # row r's uniforms do not depend on how many candidates were asked for
    np.testing.assert_array_equal(
        sampling.spec_uniforms(sp, base_index=0, rows=4, width=8)[:1],
        sampling.spec_uniforms(sp, base_index=0, rows=1, width=8))


def test_top_k_and_top_p_oracles():
    p = sampling.target_probs(np.array([[0.0, 1.0, 2.0, 3.0]]),
                              SamplingParams(temperature=1.0, top_k=2))[0]
    assert p[0] == 0.0 and p[1] == 0.0
    e = np.exp([2.0, 3.0])
    np.testing.assert_allclose(p[2:], e / e.sum(), rtol=1e-12)
    base = np.log(np.array([0.5, 0.3, 0.15, 0.05]))
    p = sampling.target_probs(base[None], SamplingParams(temperature=1.0,
                                                         top_p=0.7))[0]
    assert p[2] == 0.0 and p[3] == 0.0
    np.testing.assert_allclose(p[:2], [0.5 / 0.8, 0.3 / 0.8], rtol=1e-12)


def test_sample_tokens_support_and_greedy():
    logits = np.random.default_rng(3).normal(size=(1, 128)).astype(np.float32)
    sp = SamplingParams(temperature=1.5, top_k=4, seed=9)
    top4 = set(np.argsort(-logits[0])[:4].tolist())
    draws = [int(sampling.sample_tokens(logits, sp, index=i)[0])
             for i in range(40)]
    assert set(draws) <= top4 and len(set(draws)) > 1
    np.testing.assert_array_equal(
        sampling.sample_tokens(logits, SamplingParams(), index=5),
        logits.argmax(-1))


def test_rejection_sample_marginal_and_point_mass():
    """The emitted token at a drafted position is ~ the target p
    (chi-squared over 8 outcomes at 20k trials against 24.32, the 0.001
    critical value at 7 degrees of freedom); a point-mass target accepts
    only its argmax and resamples to it."""
    rng = np.random.default_rng(11)
    p0, p1 = rng.dirichlet(np.ones(8)), rng.dirichlet(np.ones(8))
    probs = np.stack([p0, p1])
    draft = np.array([int(p0.argmax())])
    counts = np.zeros(8, np.int64)
    for _ in range(20_000):
        u = rng.random((2, 2))
        n_acc, tok, _ = sampling.rejection_sample(probs, draft, u[:, 0],
                                                  u[:, 1])
        counts[int(draft[0]) if n_acc >= 1 else tok] += 1
    expect = p0 * counts.sum()
    assert float(((counts - expect) ** 2 / expect).sum()) < 24.32, counts
    p = np.zeros(8)
    p[5] = 1.0
    pm = np.stack([p, p])
    assert sampling.rejection_sample(pm, np.array([5]), np.array([0.99, .5]),
                                     np.array([.5, .5]))[:2] == (1, 5)
    assert sampling.rejection_sample(pm, np.array([2]), np.array([0.0, .5]),
                                     np.array([.5, .5])) == (0, 5, True)


# -- the engines ------------------------------------------------------------------

def _run(batcher, requests):
    """Queue every request before the worker sees any, then wait."""
    with batcher._cond:
        futs = [batcher.submit(t, **kw) for t, kw in requests]
    return [f.result(timeout=300) for f in futs]


def _prompts():
    rng = np.random.default_rng(21)
    system = rng.integers(0, 512, 16)
    rows = [rng.integers(0, 512, n).astype(np.int32) for n in (20, 9, 33)]
    rows[2][:16] = system
    rows.append(np.concatenate([system, rng.integers(0, 512, 7)]).astype(
        np.int32))
    return rows


@pytest.mark.parametrize("kw", SAMPLED[:2])
def test_sampled_paged_alone_and_in_a_full_batch_equal_jax(engines, kw):
    """One sampled request alone, then inside a full batch of greedy and
    sampled neighbours (and an n = 3 fork): the JAX batcher's tokens and
    stats, and the lone request's tokens do not depend on the batch."""
    jengine, engine = engines
    jp, pp = _pair(**kw)
    ps = _prompts()
    solo_j, solo_p = [(ps[0], {"sampling": jp})], [(ps[0], {"sampling": pp})]
    full = [(ps[0], "s"), (ps[1], None), (ps[2], "s"), (ps[3], None),
            (ps[1], "n3")]

    def reqs(sp):
        out = []
        for t, k in full:
            if k is None:
                out.append((t, {}))
            elif k == "s":
                out.append((t, {"sampling": sp}))
            else:
                out.append((t, {"sampling": sp, "n": 3}))
        return out

    jb, pb = JaxPagedBatcher(jengine, max_batch=8), \
        PagedBatcher(engine, max_batch=8)
    try:
        want = _run(jb, solo_j) + _run(jb, reqs(jp))
        got = _run(pb, solo_p) + _run(pb, reqs(pp))
        js, pst = jb.collect_stats(), pb.collect_stats()
    finally:
        jb.close()
        pb.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], got[1])   # batch-independent
    assert got[5].shape == (3, SC["max_new_tokens"])
    assert pst == js
    assert pst["sampled_requests"] == 4 and pst["forks"] == 2


def test_dense_engine_and_batcher_equal_paged(engines):
    """Row r of a dense batch is candidate r: the dense engine's rows, the
    dense batcher's n = 3 and the paged fork give the same tokens, as in
    JAX; a sampled request runs alone in the dense batcher."""
    jengine, engine = engines
    jp, pp = _pair(**SAMPLED[0])
    prompt = _prompts()[1]
    dense = engine.generate(np.repeat(prompt[None], 3, 0),
                            max_new_tokens=10, sampling=pp)
    np.testing.assert_array_equal(
        dense, jengine.generate(np.repeat(prompt[None], 3, 0),
                                max_new_tokens=10, sampling=jp))
    pb, cb = PagedBatcher(engine, max_batch=4), ContinuousBatcher(engine)
    jcb = JaxContinuousBatcher(jengine)
    try:
        paged = pb.generate(prompt, sampling=pp, n=3, max_new_tokens=10)
        reqs = [(prompt, {"sampling": pp, "n": 3, "max_new_tokens": 10}),
                (prompt, {"max_new_tokens": 10}),
                (prompt, {"max_new_tokens": 10})]
        jreqs = [(prompt, {"sampling": jp, "n": 3, "max_new_tokens": 10}),
                 (prompt, {"max_new_tokens": 10}),
                 (prompt, {"max_new_tokens": 10})]
        got, want = _run(cb, reqs), _run(jcb, jreqs)
        cs, js = cb.collect_stats(), jcb.collect_stats()
    finally:
        pb.close()
        cb.close()
        jcb.close()
    np.testing.assert_array_equal(paged, dense)
    np.testing.assert_array_equal(got[0], dense)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert cs == js and cs["sampled_requests"] == 1
    assert cs["batches"] == 2      # the two greedy ones merged, not the fork


def test_fork_shares_prompt_blocks_and_candidate_zero_is_solo(engines):
    jengine, engine = engines
    jp, pp = _pair(**SAMPLED[1])
    prompt = _prompts()[2]                        # 33 tokens: 2 full blocks
    pb = PagedBatcher(engine, max_batch=4)
    jb = JaxPagedBatcher(jengine, max_batch=4)
    try:
        shared = []
        pb.submit(prompt, sampling=pp, n=3,
                  on_token=lambda i, tok: shared.append(
                      pb.cache.allocator.refcount(
                          int(pb._active[0].tables[0, 0]))) if i == 0
                  else None).result(timeout=300)
        fork = pb.generate(prompt, sampling=pp, n=3)
        solo = pb.generate(prompt, sampling=pp)
        want = jb.generate(prompt, sampling=jp, n=3)
        js, ps = jb.collect_stats(), pb.collect_stats()
    finally:
        pb.close()
        jb.close()
    np.testing.assert_array_equal(fork, want)
    np.testing.assert_array_equal(fork[:1], solo)
    assert len({tuple(r) for r in fork}) > 1       # candidates diverge
    assert shared and shared[0] >= 3                # prompt block shared
    assert ps["forks"] == 4 and js["forks"] == 2


def test_per_candidate_stop_equals_jax(engines):
    """A candidate that samples the stop token freezes to stop padding
    while its siblings go on, in both packages."""
    jengine, engine = engines
    jp, pp = _pair(temperature=1.0, top_k=3, seed=11)
    prompt = _prompts()[1]
    free = PagedBatcher(engine, max_batch=4)
    try:
        free_run = free.generate(prompt, sampling=pp, n=3)
    finally:
        free.close()
    stop = int(free_run[1, 4])    # a token candidate 1 samples mid-run
    pb = PagedBatcher(engine, max_batch=4)
    jb = JaxPagedBatcher(jengine, max_batch=4)
    try:
        got = pb.generate(prompt, sampling=pp, n=3, stop_token=stop)
        want = jb.generate(prompt, sampling=jp, n=3, stop_token=stop)
    finally:
        pb.close()
        jb.close()
    np.testing.assert_array_equal(got, want)
    row = got[1]
    first = int(np.argmax(row == stop))
    assert (row[first:] == stop).all()
    assert not (got == stop).all(axis=0).any()   # retired before it


def test_rejection_sampled_spec_decode_equals_jax(engines):
    """A repetitive prompt drafts; sampled verify steps accept by
    rejection sampling and resample on rejection: the same tokens and the
    same ``spec_resamples`` as JAX, with spec decode on in both."""
    jengine, engine = engines
    rng = np.random.default_rng(5)
    prompt = np.resize(rng.integers(0, 512, 3), 24).astype(np.int32)
    reqs = []
    for seed in (1, 3):
        reqs.append((prompt, dict(temperature=1.0, top_k=2, seed=seed,
                                  max_new_tokens=24)))
    jb, pb = JaxPagedBatcher(jengine, max_batch=4), \
        PagedBatcher(engine, max_batch=4)
    try:
        for t, kw in reqs:
            jp, pp = _pair(**{k: v for k, v in kw.items()
                              if k != "max_new_tokens"})
            want = jb.generate(t, sampling=jp, max_new_tokens=24)
            got = pb.generate(t, sampling=pp, max_new_tokens=24)
            np.testing.assert_array_equal(got, want)
        js, ps = jb.collect_stats(), pb.collect_stats()
    finally:
        jb.close()
        pb.close()
    assert ps == js
    assert ps["spec_steps"] > 0 and ps["spec_resamples"] > 0


def test_multirow_prompt_with_n_is_refused_like_jax(engines):
    jengine, engine = engines
    two = np.stack([_prompts()[0][:9], _prompts()[1]])
    for b in (PagedBatcher(engine, max_batch=4), ContinuousBatcher(engine),
              JaxPagedBatcher(jengine, max_batch=4),
              JaxContinuousBatcher(jengine)):
        try:
            with pytest.raises(ValueError, match="single-row prompt"):
                b.submit(two, n=2)
        finally:
            b.close()


@pytest.mark.parametrize("kw", [None, SAMPLED[0]])
def test_generate_start_from_and_on_token(engines, kw):
    """The stream-resume contract: ``start_from`` skips what was delivered
    and ``on_token`` sees each delivered column; both as in JAX."""
    jengine, engine = engines
    jp, pp = (None, None) if kw is None else _pair(**kw)
    prompt = np.stack([_prompts()[1], _prompts()[1][::-1]])
    seen, jseen = [], []
    full = engine.generate(prompt, max_new_tokens=8, sampling=pp)
    got = engine.generate(prompt, max_new_tokens=8, sampling=pp,
                          start_from=3,
                          on_token=lambda i, t: seen.append((i, t.copy())))
    want = jengine.generate(prompt, max_new_tokens=8, sampling=jp,
                            start_from=3,
                            on_token=lambda i, t: jseen.append((i, t)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full[:, 3:])
    assert [i for i, _ in seen] == [i for i, _ in jseen] == list(range(3, 8))
    for (_, a), (_, b) in zip(seen, jseen):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_admit_stream_resumes_from_a_record_cursor():
    s, js = prompt_record_struct(5), jax_prompt_struct(5)
    rng = np.random.default_rng(3)
    chunks = [rng.integers(0, 512, (n, 5)).astype("<u4") for n in (3, 4, 2)]
    buf, first = b"", 0
    for c in chunks:
        recs = np.zeros(len(c), dtype=[("tokens", "<u4", (5,))])
        recs["tokens"] = c
        buf += pages.write_page(s.name, recs, first_record=first)
        first += len(c)
    assert buf == b"".join(jpages.write_page(js.name, np.frombuffer(
        pages.read_payload(buf, off), np.uint8).reshape(-1, 20),
        first_record=pages.read_header(buf, off).first_record)
        for off in pages.iter_pages(buf))
    ing, jing = PageIngest(device="cpu"), JaxPageIngest()
    ing.register(s)
    jing.register(js)
    for cursor in (0, 3, 5, 7, 9):
        got = [r.columns["tokens"].numpy()
               for r in ing.admit_stream(buf, cursor=cursor)]
        want = [np.asarray(r.columns["tokens"])
                for r in jing.admit_stream(buf, cursor=cursor)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(list(ing.admit_stream(buf, cursor=5))) == 2
    assert not list(ing.admit_stream(buf, cursor=9))

"""The port's paged decoder against the JAX ``DecoderLM`` on the same weights.

JAX ``DecoderLM.init`` draws the parameters; ``params_from_numpy`` hands
the same numbers to the port.  Both packages then run the same sequence
of paged steps — a prefill chunk, a mixed step (prefill rows, a decode row
padded to the chunk width, an idle row), a decode step and a speculative
verify step of width ``spec_len + 1`` — on the same pool, tables,
positions and ``last_idx``.  Logits and pool contents (outside the null
block 0, where padding writes land in an unspecified order) must agree at
float32 tolerance: atol 1e-4 / rtol 1e-4, room for two 2-layer stacks of
float32 matmuls summed in different orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import DecoderLM

TOL = dict(atol=1e-4, rtol=1e-4)
B, M, BS = 4, 4, 8          # rows, table width, block size
N_BLOCKS = B * M + 1


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    cfg = reduced_config(get_config("qwen2-1.5b"))
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    return jmodel, jparams, DecoderLM(cfg), params


def test_config_copy_matches_jax_field_for_field():
    import dataclasses
    jcfg = jax_get_config("qwen2-1.5b")
    cfg = get_config("qwen2-1.5b")
    jf = dataclasses.asdict(jcfg)
    pf = dataclasses.asdict(cfg)
    assert jf.pop("attention_impl") == "reference"
    assert pf.pop("attention_impl") == "kernel"   # the documented departure
    assert jf == pf
    assert dataclasses.asdict(jax_reduced_config(jcfg))["d_model"] == \
        dataclasses.asdict(reduced_config(cfg))["d_model"] == 64


def test_params_tree_and_init_shapes(models):
    jmodel, jparams, model, params = models
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jparams)[0]}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = tuple(v.shape)
        return out

    assert flat(params) == flat_j
    # the port's own seeded init has the same tree
    assert flat(model.init(0, torch.device("cpu"))) == flat_j


def _steps(rng):
    """(kind, tokens, positions, last_idx) for the step sequence."""
    v = 512
    c = 8
    pre = rng.integers(0, v, (B, c)).astype(np.int32)
    pos0 = np.broadcast_to(np.arange(c, dtype=np.int32), (B, c)).copy()
    last0 = np.array([7, 7, 4, 0], np.int32)   # rows advance 8, 8, 5, 1
    adv = last0 + 1
    # mixed: rows 0-1 prefill 8 more, rows 2-3 decode one token each,
    # padded to the chunk width (padding K/V routed to block 0)
    mix = rng.integers(0, v, (B, c)).astype(np.int32)
    last1 = np.array([7, 7, 0, 0], np.int32)
    pos1 = adv[:, None] + np.minimum(np.arange(c), last1[:, None])
    adv = adv + last1 + 1
    dec = rng.integers(0, v, (B, 1)).astype(np.int32)
    pos2 = adv[:, None].astype(np.int32)
    adv = adv + 1
    ver = rng.integers(0, v, (B, 5)).astype(np.int32)
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
    jpool = jmodel.init_paged_pool(N_BLOCKS, BS)
    pool = model.init_paged_pool(N_BLOCKS, BS, torch.device("cpu"))
    jstep = jax.jit(jmodel.paged_step)
    jverify = jax.jit(jmodel.paged_step_verify)
    for kind, toks, pos, last in _steps(rng):
        jfn, fn = (jstep, model.paged_step) if kind == "step" \
            else (jverify, model.paged_step_verify)
        jlog, jpool = jfn(jparams, jnp.asarray(toks), jpool,
                          jnp.asarray(tables), jnp.asarray(pos),
                          jnp.asarray(last))
        log, pool = fn(params, torch.from_numpy(toks), pool,
                       *(torch.from_numpy(a) for a in (tables, pos, last)))
        assert np.isfinite(log.numpy()).all()
        want = np.asarray(jlog)
        if kind == "verify":
            for r in range(B):   # positions past last_idx are padding
                np.testing.assert_allclose(log.numpy()[r, :last[r] + 1],
                                           want[r, :last[r] + 1], **TOL)
        else:
            np.testing.assert_allclose(log.numpy(), want, **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(pool[name].numpy()[:, 1:],
                                       np.asarray(jpool[name])[:, 1:], **TOL)


def test_plain_reference_impl_matches_kernel_dispatch_on_cpu(models):
    """attention_impl="reference" (the plain version by name) and the
    default dispatch run the same arithmetic on CPU tensors."""
    import dataclasses
    _, _, model, params = models
    ref = DecoderLM(dataclasses.replace(model.cfg, attention_impl="reference"))
    tables = torch.from_numpy(np.arange(B * M, dtype=np.int32)
                              .reshape(B, M) + 1)
    outs = []
    for m in (model, ref):
        pool = m.init_paged_pool(N_BLOCKS, BS, torch.device("cpu"))
        for _, toks, pos, last in _steps(np.random.default_rng(1))[:3]:
            log, pool = m.paged_step(params, torch.from_numpy(toks), pool,
                                     tables, torch.from_numpy(pos),
                                     torch.from_numpy(last))
        outs.append(log)
    torch.testing.assert_close(outs[0], outs[1], **TOL)


def test_bridge_keeps_lam_float32_in_a_bf16_hybrid():
    """A bfloat16 JAX ``HybridLM`` tree round-trips through the bridge with
    every leaf bfloat16 except the RG-LRU's ``lam``, which the JAX init
    keeps float32; values are unchanged."""
    import dataclasses
    jcfg = dataclasses.replace(
        jax_reduced_config(jax_get_config("recurrentgemma-9b")),
        dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu", dtype=torch.bfloat16)
    jflat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    got = dict(flat(params))
    assert sorted(got) == sorted(jflat)
    lams = [name for name in got if name.endswith("/lam")]
    assert lams
    for name, leaf in got.items():
        want = np.asarray(jflat[name])
        assert leaf.dtype == (torch.float32 if name in lams
                              else torch.bfloat16), name
        assert str(want.dtype) == ("float32" if name in lams
                                   else "bfloat16"), name
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      want.astype(np.float32), err_msg=name)

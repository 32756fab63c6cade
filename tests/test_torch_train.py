"""The port's training path against the JAX package's, on the CPU.

* ``lr_schedule`` at steps 0..50 and one ``adamw_update`` on the same
  params, grads and state (float32, within 1e-6); ``compress_grads`` bf16
  bit-equal, int8 with error feedback bit-equal (``q`` and ``ef``) over
  three steps;
* one train step's loss and gradients for every family JAX's
  ``model.loss`` serves (reduced configs, float32, the JAX init's weights
  through ``params_from_numpy``), within the JAX kernel tests' f32
  tolerance atol 3e-5 / rtol 1e-4; also ``grad_accum=2`` (against the
  mean over JAX's microbatches, as its scan computes it) and the chunked
  loss with ``remat="full"``; the full step (``make_train_step``);
* the JAX package's trainer tests ported: the loss falls and a restart
  resumes step and cursor, a preemption writes an emergency checkpoint,
  the watchdog, AdamW on a quadratic;
* repair of the kernel wrappers: under grad mode an input that requires
  grad makes every CUDA wrapper raise (here on meta tensors, which take
  the kernel route; on the card in the ``cuda`` case).
"""
import dataclasses
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.train import optimizer as JO
from repro.train.train_loop import make_train_step as jax_make_train_step

from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.format import flatten_tree
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import (BufferSource, DataConfig, Pipeline,
                              synthetic_corpus, write_example_pages)
from repro_torch.kernels import bebop_decode as bd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import get_model
from repro_torch.train import (OptimizerConfig, PreemptionHandler,
                               StepWatchdog, TrainConfig, Trainer,
                               make_train_step)
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import loss_and_grads

TOL = dict(atol=3e-5, rtol=1e-4)
B, T = 2, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x):
    """The bits of a float32 / bfloat16 tensor or array, as integers."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


# -- optimizer ------------------------------------------------------------------


def test_lr_schedule_equals_jax():
    """float32 like JAX's: the warmup ramp bit-equal, the cosine part
    within two float32 ulps (XLA's cos and PyTorch's round differently in
    the last bit at some steps)."""
    for cfg in (OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=50),
                OptimizerConfig(lr=1.0, warmup_steps=0, total_steps=30,
                                min_lr_ratio=0.2)):
        jcfg = JO.OptimizerConfig(**dataclasses.asdict(cfg))
        steps = np.arange(51, dtype=np.int32)
        got = O.lr_schedule(cfg)(torch.from_numpy(steps))
        want = np.asarray(JO.lr_schedule(jcfg)(jnp.asarray(steps)))
        assert got.dtype == torch.float32
        w = cfg.warmup_steps
        np.testing.assert_array_equal(got.numpy()[:w + 1], want[:w + 1])
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)


def _opt_tree(rng):
    """Leaves of every rank the model has: a matrix, a stacked per-layer
    norm [L, D] (decays), an unstacked norm [D] (does not), a nested
    dict."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": f(8, 6), "final_norm": 1 + 0.1 * f(6),
            "layers": {"ln1": 1 + 0.1 * f(2, 6), "w": f(2, 6, 4)}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    rng = np.random.default_rng(0)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    m, v = _opt_tree(rng), _opt_tree(rng)
    v = jax.tree_util.tree_map(lambda a: a * a, v)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20,
              moment_dtype=moment_dtype, clip_norm=0.5)
    cfg, jcfg = OptimizerConfig(**kw), JO.OptimizerConfig(**kw)
    mdt = jnp.dtype(moment_dtype)
    jstate = {"m": jax.tree_util.tree_map(lambda a: jnp.asarray(a, mdt), m),
              "v": jax.tree_util.tree_map(lambda a: jnp.asarray(a, mdt), v),
              "step": jnp.int32(3)}
    jp, js = JO.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads),
                             jstate, jax.tree_util.tree_map(jnp.asarray,
                                                            params), jcfg)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        moment_dtype]
    t = lambda tree, dt=torch.float32: O.tree_map(  # noqa: E731
        lambda a: torch.from_numpy(np.array(a)).to(dt), tree)
    state = {"m": t(m, tdt), "v": t(v, tdt),
             "step": torch.tensor(3, dtype=torch.int32)}
    p, s = O.adamw_update(t(grads), state, t(params), cfg)
    assert int(s["step"]) == int(js["step"]) == 4
    for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
        want = dict(flatten_tree(_np(want)))
        for name, leaf in flatten_tree(got):
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(want[name], np.float32),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
    # the global norm sums the leaves in the JAX tree's order
    np.testing.assert_allclose(float(O.global_norm(t(grads))),
                               float(JO.global_norm(grads)), rtol=1e-6)


def test_compress_grads_bf16_bit_equal():
    rng = np.random.default_rng(1)
    g = _opt_tree(rng)
    cfg = OptimizerConfig(compression="bf16")
    got, _ = O.compress_grads(O.tree_map(torch.from_numpy, g), {}, cfg)
    want, _ = JO.compress_grads(g, {}, JO.OptimizerConfig(compression="bf16"))
    want = dict(flatten_tree(_np(want)))
    for name, leaf in flatten_tree(got):
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(leaf), _bits(want[name]))


def test_compress_grads_int8_error_feedback_bit_equal():
    """Three steps, the error feedback carried: the dequantized grads and
    ``ef`` (bfloat16) bit-equal to JAX's (both round half to even)."""
    rng = np.random.default_rng(2)
    params = _opt_tree(rng)
    cfg = OptimizerConfig(compression="int8")
    jcfg = JO.OptimizerConfig(compression="int8")
    state = O.init_opt_state(O.tree_map(torch.from_numpy, params), cfg)
    jstate = JO.init_opt_state(params, jcfg)
    for step in range(3):
        g = _opt_tree(rng)
        got, state = O.compress_grads(O.tree_map(torch.from_numpy, g), state,
                                      cfg)
        want, jstate = JO.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jcfg)
        for tree, jtree in ((got, want), (state["ef"], jstate["ef"])):
            jflat = dict(flatten_tree(_np(jtree)))
            for name, leaf in flatten_tree(tree):
                np.testing.assert_array_equal(
                    _bits(leaf), _bits(jflat[name]),
                    err_msg=f"step {step} {name}")
    assert any(bool(e.abs().max() > 0) for e in O.leaves(state["ef"]))


def test_int8_rounds_half_to_even():
    g = {"w": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])}
    e = {"w": torch.zeros(6, dtype=torch.bfloat16)}
    q, _ = O.compress_grads(g, {"ef": e}, OptimizerConfig(compression="int8"))
    assert q["w"].tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -2.0]


def test_adamw_converges_quadratic():
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = O.init_opt_state(params, cfg)
    for _ in range(150):
        params, state = O.adamw_update({"w": 2 * params["w"]}, state, params,
                                       cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_int8_error_feedback_converges():
    cfg = OptimizerConfig(lr=0.05, warmup_steps=0, total_steps=400,
                          weight_decay=0.0, compression="int8")
    params = {"w": torch.tensor([4.0, -2.0])}
    state = O.init_opt_state(params, cfg)
    for _ in range(300):
        grads, state = O.compress_grads({"w": 2 * params["w"]}, state, cfg)
        params, state = O.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_weight_decay_on_stacked_norms_only():
    """Leaves with ndim >= 2 decay: the stacked [L, D] norms do, the
    unstacked final norm does not (a zero gradient isolates the decay)."""
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    params = {"final_norm": torch.ones(4), "layers": {"ln1": torch.ones(2, 4)}}
    grads = O.tree_map(torch.zeros_like, params)
    p, _ = O.adamw_update(grads, O.init_opt_state(params, cfg),
                          O.tree_map(torch.clone, params), cfg)
    assert torch.equal(p["final_norm"], torch.ones(4))
    assert bool((p["layers"]["ln1"] < 1).all())


# -- one train step of every family -------------------------------------------

FAMILIES = [(a, {}, 1) for a in (
    "qwen2-1.5b", "gemma-2b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
    "rwkv6-7b", "qwen2-vl-2b", "seamless-m4t-medium")] + [
    ("qwen2-1.5b", {}, 2),
    ("qwen2-1.5b", {"loss_chunk": 8, "remat": "full"}, 1),
    ("recurrentgemma-9b", {"remat": "full"}, 1),
    ("seamless-m4t-medium", {"remat": "full"}, 1)]


def _family(arch, over):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               **over)
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              attention_impl="reference", **over)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np(jparams), device="cpu",
                               dtype=torch.float32)
    return jmodel, jparams, get_model(cfg), params, cfg


def _batch(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, T))
             .astype(np.int32)}
    batch["labels"][0, :3] = -1          # ignored positions
    if cfg.input_kind == "embeddings":
        batch["embeds"] = rng.standard_normal((b, T, cfg.d_model)) \
            .astype(np.float32)
        t = np.arange(T)      # M-RoPE: time, then a 4-wide patch grid
        batch["positions"] = np.stack([t, t // 4, t % 4]).astype(
            np.int32)[:, None].repeat(b, 1)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, T)) \
            .astype(np.int32)
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((b, 4, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _jax_loss_and_grads(jmodel, jparams, batch, k):
    """JAX's step as ``make_train_step`` computes it: value_and_grad of
    ``model.loss``, or for k > 1 the mean over microbatches."""
    vg = jax.jit(jax.value_and_grad(jmodel.loss))
    outs = [vg(jparams, {n: jnp.asarray(x.reshape(
        (k, x.shape[0] // k) + x.shape[1:])[i]) for n, x in batch.items()})
        for i in range(k)]
    loss = sum(float(o[0]) for o in outs) / k
    grads = jax.tree_util.tree_map(
        lambda *g: sum(np.asarray(x, np.float32) for x in g) / k,
        *[o[1] for o in outs])
    return loss, grads


@pytest.mark.parametrize("arch,over,accum", FAMILIES,
                         ids=[f"{a}{''.join(f'-{k}' for k in o)}"
                              f"{f'-accum{n}' if n > 1 else ''}"
                              for a, o, n in FAMILIES])
def test_train_step_matches_jax(arch, over, accum):
    jmodel, jparams, model, params, cfg = _family(arch, over)
    batch = _batch(cfg, B * accum)
    want_loss, want = _jax_loss_and_grads(jmodel, jparams, batch, accum)
    tb = {n: torch.from_numpy(x) for n, x in batch.items()}
    loss, grads = loss_and_grads(model, params, tb, accum)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    want = dict(flatten_tree(_np(want)))
    got = dict(flatten_tree(grads))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("accum", [1, 2])
def test_full_step_matches_jax(accum):
    """``make_train_step`` (loss, grads, AdamW) against JAX's on one batch.
    A first step moves each parameter by lr * g / (|g| + eps): eps 1e-4
    keeps that continuous where |g| is at the level of the two packages'
    rounding."""
    jmodel, jparams, model, params, cfg = _family("qwen2-1.5b", {})
    batch = _batch(cfg, 2 * B)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, eps=1e-4,
                           grad_accum=accum)
    jcfg = JO.OptimizerConfig(**dataclasses.asdict(ocfg))
    jp, js, jl = jax.jit(jax_make_train_step(jmodel, jcfg))(
        jparams, JO.init_opt_state(jparams, jcfg),
        {n: jnp.asarray(x) for n, x in batch.items()})
    p, s, lv = make_train_step(model, ocfg)(
        params, O.init_opt_state(params, ocfg),
        {n: torch.from_numpy(x) for n, x in batch.items()})
    np.testing.assert_allclose(float(lv), float(jl), **TOL)
    assert int(s["step"]) == int(js["step"]) == 1
    jflat = dict(flatten_tree(_np(jp)))
    for name, leaf in flatten_tree(p):
        np.testing.assert_allclose(leaf.numpy(), jflat[name], **TOL,
                                   err_msg=name)


# -- the trainer ----------------------------------------------------------------


def _pages(cfg, seq, n, seed):
    toks = synthetic_corpus(seq, n, cfg.vocab_size, seed=seed)
    return write_example_pages(seq, toks, records_per_page=8)


def test_train_loss_decreases_and_restart_resumes():
    cfg = reduced_config(get_config("gemma-2b"))
    seq, gb = 16, 4
    buf = _pages(cfg, seq, 256, 5)
    dc = DataConfig(seq_len=seq, global_batch=gb, records_per_page=8)
    src = BufferSource(buf)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    with tempfile.TemporaryDirectory() as td:
        pipe = Pipeline(dc, [src], len(src))
        tr = Trainer(cfg, opt, TrainConfig(steps=12, ckpt_every=6,
                                           ckpt_dir=td, log_every=4),
                     data=iter(pipe), device="cpu")
        res = tr.run()
        pipe.stop()
        assert res["status"] == "done" and res["step"] == 12
        assert res["losses"][-1][1] < res["losses"][0][1]
        # restart resumes step + cursor from the checkpoint
        pipe2 = Pipeline(dc, [src], len(src), cursor=tr.data_cursor)
        tr2 = Trainer(cfg, opt, TrainConfig(steps=14, ckpt_every=6,
                                            ckpt_dir=td, log_every=4),
                      data=iter(pipe2), device="cpu")
        assert tr2.step == 12 and tr2.data_cursor == tr.data_cursor == 48
        res2 = tr2.run()
        pipe2.stop()
        assert res2["step"] == 14
        # the restored state is the saved one: moments float32, step int32
        assert tr2.opt_state["m"]["embed"].dtype == torch.float32
        assert tr2.opt_state["step"].dtype == torch.int32


def test_restart_losses_equal_uninterrupted_run():
    """5 steps, save, resume for 5 more: the losses of steps 6-10 are the
    uninterrupted run's, bit for bit (the CPU is deterministic)."""
    cfg = reduced_config(get_config("qwen2-1.5b"))
    seq = 16
    buf = _pages(cfg, seq, 128, 9)
    dc = DataConfig(seq_len=seq, global_batch=4, records_per_page=8)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def run(steps, td, cursor=0):
        pipe = Pipeline(dc, [BufferSource(buf)], len(BufferSource(buf)),
                        cursor=cursor)
        tr = Trainer(cfg, opt, TrainConfig(steps=steps, ckpt_every=100,
                                           ckpt_dir=td, log_every=1),
                     data=iter(pipe), device="cpu")
        res = tr.run()
        pipe.stop()
        return tr, res

    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        _, full = run(10, a)
        first, _ = run(5, b)
        second, rest = run(10, b, cursor=first.data_cursor)
    assert rest["losses"] == full["losses"][5:]
    assert second.data_cursor == 40


def test_preemption_emergency_checkpoint():
    cfg = reduced_config(get_config("qwen2-1.5b"))
    seq, gb = 16, 4
    buf = _pages(cfg, seq, 128, 6)
    dc = DataConfig(seq_len=seq, global_batch=gb, records_per_page=8)
    src = BufferSource(buf)
    with tempfile.TemporaryDirectory() as td:
        pipe = Pipeline(dc, [src], len(src))
        tr = Trainer(cfg, OptimizerConfig(),
                     TrainConfig(steps=50, ckpt_every=100, ckpt_dir=td),
                     data=iter(pipe), device="cpu")
        tr.preemption.trigger()  # simulate SIGTERM
        res = tr.run()
        pipe.stop()
        assert res["status"] == "preempted"
        assert tr.ckpt.latest_step() is not None  # emergency checkpoint


@pytest.mark.parametrize("donate", [True, False])
def test_donate_false_keeps_earlier_tensors(donate):
    """Params update in place (JAX's donation); with ``donate=False`` a
    tensor taken before a step keeps its values, as a JAX array does."""
    cfg = reduced_config(get_config("qwen2-1.5b"))
    buf = _pages(cfg, 16, 32, 7)
    src = BufferSource(buf)
    pipe = Pipeline(DataConfig(seq_len=16, global_batch=4,
                               records_per_page=8), [src], len(src))
    tr = Trainer(cfg, OptimizerConfig(lr=1e-2, warmup_steps=0),
                 TrainConfig(steps=2), data=iter(pipe), device="cpu",
                 donate=donate)
    before = tr.params["final_norm"]
    saved = before.clone()
    tr.run()
    pipe.stop()
    assert not torch.equal(tr.params["final_norm"], saved)
    assert torch.equal(before, saved) is not donate
    import tempfile
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    try:
        with tempfile.TemporaryDirectory() as td:
            Trainer(cfg, OptimizerConfig(), TrainConfig(ckpt_dir=td),
                    data=iter(()), mesh=mesh, device="cpu").run()
            man = CheckpointManager(td).manifest(0)
    finally:
        dist.destroy_process_group()
    assert tuple(man["mesh_shape"]) == (1, 1)
    assert tuple(man["mesh_axes"]) == ("data", "model")


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, OptimizerConfig(), TrainConfig(), data=iter(()))


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "qwen2-1.5b", "--steps", "3", "--seq-len", "16",
                 "--global-batch", "4", "--num-examples", "64",
                 "--log-every", "1"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "finished: done at step 3" in out and "device=cpu" in out


def test_preemption_flag():
    h = PreemptionHandler()
    assert not h.preempted
    h.trigger()
    assert h.preempted


def test_watchdog_detects_hang():
    events = []
    w = StepWatchdog(0.15, on_hang=lambda: events.append(1))
    w.step_started()
    time.sleep(0.5)
    w.stop()
    assert w.hung and events


def test_watchdog_ok_when_steps_finish():
    w = StepWatchdog(0.3)
    for _ in range(3):
        w.step_started()
        time.sleep(0.02)
        w.step_finished()
    time.sleep(0.4)
    w.stop()
    assert not w.hung


# -- the kernel wrappers refuse to launch under grad ------------------------------


def _grad_calls(dev):
    """(name, call) for every CUDA wrapper, each given a float input that
    requires grad.  A page that requires grad can only be a float tensor:
    the guard refuses it before the wrapper's dtype check."""
    def f(*shape):
        return torch.zeros(shape, device=dev, requires_grad=True)
    q, kv = f(1, 2, 4, 64), f(1, 1, 4, 64)
    pool = torch.zeros((3, 1, 16, 64), device=dev)
    tables = torch.ones((1, 2), dtype=torch.int32, device=dev)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    x = f(1, 4, 16)
    r, u = f(1, 2, 4, 16), torch.zeros((2, 16), device=dev)
    return [
        ("flash_attention", lambda: fa.flash_attention(q, kv, kv)),
        ("paged_attention", lambda: pa.paged_attention(
            q[:, :, 0], pool, pool, tables, pos[:, 0] + 1)),
        ("paged_prefill_attention", lambda: pa.paged_prefill_attention(
            q, pool, pool, tables, pos)),
        ("rglru_scan", lambda: rg.rglru_scan(x, x.detach())),
        ("rwkv6_scan", lambda: rw.rwkv6_scan(r, r, r, r, u)),
        ("decode_columns", lambda: bd.decode_columns(
            f(2, 8), [(0, 2, "uint32", "int32")])),
        ("decode_column", lambda: bd.decode_column(
            f(2, 8), offset=0, count=2, wire_dtype="uint32")),
    ]


def _assert_refused(dev):
    for name, call in _grad_calls(dev):
        with pytest.raises(ValueError, match=f"{name}: the CUDA kernel has "
                                             f"no backward"):
            call()


def test_wrappers_refuse_grad_before_launching():
    """Meta tensors are not on the CPU, so the wrappers take the kernel
    route: the guard raises before any library is built or loaded."""
    _assert_refused(torch.device("meta"))


def test_plain_route_under_grad_is_unchanged():
    """A CPU tensor that requires grad still takes the differentiable
    plain version."""
    q = torch.randn((1, 2, 4, 16), requires_grad=True)
    kv = torch.randn((1, 1, 4, 16))
    fa.flash_attention(q, kv, kv).sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def test_cuda_wrappers_refuse_grad(cuda):
    _assert_refused(cuda)
    with torch.no_grad():     # the serving paths launch as before
        q = torch.randn((1, 2, 4, 64), device=cuda, requires_grad=True)
        kv = torch.randn((1, 1, 4, 64), device=cuda)
        fa.flash_attention(q, kv, kv)


def test_nothing_detaches_silently_on_the_kernel_route():
    """The training model is built with ``attention_impl="reference"``, so
    differentiating it never reaches a wrapper's kernel route."""
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    tr = Trainer(cfg, OptimizerConfig(), TrainConfig(steps=0),
                 data=iter(()), device="cpu")
    assert tr.model.cfg.attention_impl == "reference"
    assert cfg.attention_impl == "kernel"
    assert tr.run()["status"] == "done"

"""The port's dry run and its mesh-placed training state, on the CPU.

* FLOP parity: the reduced gemma-2b train step traced on the (1, 1) host
  mesh counts the FLOPs the JAX package's HLO analysis counts for its
  compiled step, within 2%.
* DTensor forward: reduced qwen2-1.5b logits with the params placed by
  ``param_specs`` on a CPU (1, 1) mesh, in ``tp`` and in ``fsdp`` with the
  per-layer gather, equal the plain forward bit for bit (one rank runs the
  same ops) and the JAX forward at 3e-5 / 1e-4.
* Checkpoints: ``restore(shardings=)`` returns DTensors with the requested
  placements and the saved bits; a JAX-written checkpoint saved with
  mesh_shape (16, 16) restores onto the port's mesh; ``Trainer(mesh=)``
  writes the mesh shape and axis names the JAX ``Trainer`` writes.
* The CLI as a user runs it: ``rwkv6-7b long_500k`` on both production
  meshes in a subprocess (its own fake group of 512 ranks), with the
  record keys the JAX package's test checks, and ``--list``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

import jax
import jax.numpy as jnp
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data import BufferSource as JaxBufferSource
from repro.data import DataConfig as JaxDataConfig
from repro.data import Pipeline as JaxPipeline
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import get_model as jax_get_model
from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro.train.train_loop import make_train_step as jax_train_step
from repro.utils import hlo as H

from repro_torch.checkpoint import CheckpointManager, params_from_numpy
from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.data import (BufferSource, DataConfig, Pipeline,
                              synthetic_corpus, write_example_pages)
from repro_torch.launch import cells as C
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.train import OptimizerConfig, TrainConfig, Trainer

TOL = dict(atol=3e-5, rtol=1e-4)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="module")
def mesh():
    """The (1, 1) CPU mesh over a one-rank gloo group, destroyed after."""
    assert not dist.is_initialized()
    m = make_host_mesh(device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def test_reduced_train_step_flops_match_jax(mesh, monkeypatch):
    jcfg = jax_reduced_config(jax_get_config("gemma-2b"))
    jmodel = jax_get_model(jcfg)
    params_abs = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    opt_abs = jax.eval_shape(
        lambda p: jax_init_opt_state(p, JaxOptimizerConfig()), params_abs)
    batch_abs = {"tokens": jax.ShapeDtypeStruct((2, 16), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((2, 16), jnp.int32)}
    step = jax_train_step(jmodel, JaxOptimizerConfig())
    compiled = jax.jit(step).lower(params_abs, opt_abs, batch_abs).compile()
    want = H.analyze(compiled.as_text())["flops"]

    cfg = reduced_config(get_config("gemma-2b"))
    monkeypatch.setattr(C, "get_config", lambda arch: cfg)
    monkeypatch.setitem(C.SHAPES, "tiny_train",
                        ShapeConfig("tiny_train", 16, 2, "train"))
    cell = C.Cell("gemma-2b", "tiny_train", mesh,
                  C.CellOverrides(remat="none"))
    traced = cell.trace()
    got = traced.counter.flops
    assert want > 0 and abs(got - want) <= 0.02 * want, (got, want)
    s = traced.counter.summary()
    assert s["collective_bytes"]["total"] == 0.0   # one rank
    assert traced.argument_bytes > 0 and traced.alias_bytes > 0


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    want = np.asarray(jmodel.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    return tree, tokens, want


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_dtensor_forward_equals_plain_and_jax(mesh, qwen, mode):
    tree, tokens, want = qwen
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-1.5b")),
                              attention_impl="reference",
                              fsdp_per_layer_gather=mode == "fsdp")
    model = get_model(cfg)
    params = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(tokens)}
    plain = model.logits(params, batch)
    shape = ShapeConfig("fwd", 16, 2, "prefill")
    dparams = S.distribute(params, mesh,
                           S.param_specs(cfg, params, mesh, mode=mode))
    dbatch = S.distribute(batch, mesh,
                          S.batch_specs(cfg, shape, mesh, mode=mode))
    assert all(isinstance(t, DTensor) for t in dparams["layers"]["attn"]
               .values())
    with implicit_replication():
        out = model.logits(dparams, dbatch)
    assert isinstance(out, DTensor)
    assert torch.equal(out.full_tensor(), plain)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_restore_onto_a_mesh_keeps_placements_and_bits(mesh):
    P = S.PartitionSpec
    tree = {"w": torch.randn(8, 4), "opt": {"m": torch.randn(8, 4),
                                           "step": torch.tensor(3,
                                                                dtype=torch.int32)},
            "b": torch.randn(4).to(torch.bfloat16)}
    specs = {"w": P(None, "model"), "opt": {"m": P("data", None),
                                          "step": P()},
             "b": P(None)}
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(2, tree, mesh_shape=(1, 1), mesh_axes=("data", "model"),
                 blocking=True)
        out, man = mgr.restore_latest(tree, shardings=S.named(mesh, specs))
    assert int(man["step"]) == 2
    assert out["w"].placements == (Replicate(), Shard(1))
    assert out["opt"]["m"].placements == (Shard(0), Replicate())
    assert out["opt"]["step"].placements == (Replicate(), Replicate())
    for got, saved in ((out["w"], tree["w"]), (out["opt"]["m"],
                                               tree["opt"]["m"]),
                       (out["opt"]["step"], tree["opt"]["step"]),
                       (out["b"], tree["b"])):
        assert isinstance(got, DTensor)
        assert got.to_local().dtype == saved.dtype
        assert torch.equal(got.to_local(), saved)


def test_jax_checkpoint_from_a_16x16_mesh_restores_onto_the_port(mesh):
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    with tempfile.TemporaryDirectory() as td:
        JaxCheckpointManager(td).save(1, tree, mesh_shape=(16, 16),
                                      mesh_axes=("data", "model"),
                                      blocking=True)
        shardings = S.named(mesh, {"w": S.PartitionSpec(None, None)})
        out, man = CheckpointManager(td).restore(
            1, {"w": torch.zeros(8, 8)}, shardings=shardings)
    assert tuple(int(x) for x in man["mesh_shape"]) == (16, 16)
    assert tuple(man["mesh_axes"]) == ("data", "model")
    assert isinstance(out["w"], DTensor)
    assert out["w"].placements == shardings["w"].placements
    np.testing.assert_array_equal(out["w"].to_local().numpy(), tree["w"])


def test_trainer_records_its_mesh_as_jax_does(mesh):
    seq, gb = 16, 4
    toks = synthetic_corpus(seq, 64, 512, seed=5)
    buf = write_example_pages(seq, toks, records_per_page=8)
    with tempfile.TemporaryDirectory() as td, \
            tempfile.TemporaryDirectory() as jtd:
        src = BufferSource(buf)
        pipe = Pipeline(DataConfig(seq_len=seq, global_batch=gb,
                                   records_per_page=8), [src], len(src))
        tr = Trainer(reduced_config(get_config("qwen2-1.5b")),
                     OptimizerConfig(), TrainConfig(steps=1, ckpt_dir=td),
                     data=iter(pipe), mesh=mesh, device="cpu")
        tr.run()
        pipe.stop()
        jsrc = JaxBufferSource(buf)
        jpipe = JaxPipeline(JaxDataConfig(seq_len=seq, global_batch=gb,
                                          records_per_page=8), [jsrc],
                            len(jsrc))
        jtr = JaxTrainer(jax_reduced_config(jax_get_config("qwen2-1.5b")),
                         JaxOptimizerConfig(),
                         JaxTrainConfig(steps=1, ckpt_dir=jtd),
                         data=iter(jpipe), mesh=jax_host_mesh())
        jtr.run()
        jpipe.stop()
        man = CheckpointManager(td).manifest(1)
        jman = JaxCheckpointManager(jtd).manifest(1)
    assert tuple(man["mesh_shape"]) == tuple(jman["mesh_shape"]) == (1, 1)
    assert tuple(man["mesh_axes"]) == tuple(jman["mesh_axes"]) \
        == ("data", "model")


def _dryrun(args, **kw):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300, **kw)


def test_dryrun_cli_rwkv_long_500k_both_meshes(tmp_path):
    r = _dryrun(["--arch", "rwkv6-7b", "--shape", "long_500k", "--mesh",
                 "both", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    for mesh, chips in (("single", 256), ("multi", 512)):
        rec = json.load(open(tmp_path / f"rwkv6-7b__long_500k__{mesh}"
                                        "__baseline.json"))
        assert rec["status"] == "ok"
        assert rec["chips"] == chips
        for key in ("flops_per_device", "bytes_per_device",
                    "collective_bytes", "compute_s", "memory_s",
                    "collective_s", "dominant", "model_flops",
                    "useful_ratio", "roofline_fraction", "lower_s",
                    "argument_size_in_bytes", "temp_size_in_bytes",
                    "collective_counts", "trip_count",
                    "step_time_lower_bound_s"):
            assert key in rec, key
        assert rec["flops_per_device"] > 0
        assert rec["compile_s"] > 0
        assert rec["trip_count"] == 32


def test_dryrun_cli_list_enumerates_40_cells():
    r = _dryrun(["--list"])
    assert r.returncode == 0
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 40
    assert sum(1 for ln in lines if "SKIP" in ln) == 8

"""The port's checkpoints against the JAX package's, on the CPU.

* A JAX ``Trainer`` trains 2 steps and saves; the port's ``Trainer``
  restores the checkpoint and its step 3 (loss, then params and moments)
  matches the JAX ``Trainer``'s step 3 from the same checkpoint, at the f32
  tolerance atol 3e-5 / rtol 1e-4; and the other way round.
* One tree (float32, bfloat16, int32 leaves, nested) writes byte-equal
  shard files in both packages, and each restores the other's.
* bfloat16 leaves round-trip with ``ml_dtypes`` (and ``jax``, ``repro``)
  blocked, through the port's files and through a JAX-written file.
* Atomic commit, retention, CRC corruption detection and the async save's
  snapshot, as in the JAX package's tests.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data import BufferSource as JaxBufferSource
from repro.data import DataConfig as JaxDataConfig
from repro.data import Pipeline as JaxPipeline
from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer

import repro_torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.format import flatten_tree
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import (BufferSource, DataConfig, Pipeline,
                              synthetic_corpus, write_example_pages)
from repro_torch.train import OptimizerConfig, TrainConfig, Trainer

TOL = dict(atol=3e-5, rtol=1e-4)
SEQ, GB = 16, 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


@pytest.fixture(scope="module")
def corpus():
    cfg = reduced_config(get_config("qwen2-1.5b"))
    toks = synthetic_corpus(SEQ, 96, cfg.vocab_size, seed=11)
    return write_example_pages(SEQ, toks, records_per_page=8)


def _run_jax(td, steps, buf, cursor):
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    src = JaxBufferSource(buf)
    pipe = JaxPipeline(JaxDataConfig(seq_len=SEQ, global_batch=GB,
                                     records_per_page=8), [src], len(src),
                       cursor=cursor)
    tr = JaxTrainer(jcfg, JaxOptimizerConfig(**OPT),
                    JaxTrainConfig(steps=steps, ckpt_every=100, ckpt_dir=td,
                                   log_every=1), data=iter(pipe))
    res = tr.run()
    pipe.stop()
    return tr, res


def _run_port(td, steps, buf, cursor):
    cfg = reduced_config(get_config("qwen2-1.5b"))
    src = BufferSource(buf)
    pipe = Pipeline(DataConfig(seq_len=SEQ, global_batch=GB,
                               records_per_page=8), [src], len(src),
                    cursor=cursor)
    tr = Trainer(cfg, OptimizerConfig(**OPT),
                 TrainConfig(steps=steps, ckpt_every=100, ckpt_dir=td,
                             log_every=1), data=iter(pipe), device="cpu")
    res = tr.run()
    pipe.stop()
    return tr, res


def _cursor(td):
    mgr = JaxCheckpointManager(td)
    return int(mgr.manifest(mgr.latest_step())["data_cursor"])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(corpus, first):
    """2 steps in one package, then step 3 in both from its checkpoint."""
    run_first = _run_jax if first == "jax" else _run_port
    with tempfile.TemporaryDirectory() as a:
        b = os.path.join(a, "copy")
        a = os.path.join(a, "orig")
        run_first(a, 2, corpus, 0)
        shutil.copytree(a, b)
        cursor = _cursor(a)
        assert cursor == 2 * GB
        jtr, jres = _run_jax(a, 3, corpus, cursor)
        ptr, pres = _run_port(b, 3, corpus, cursor)
    assert jres["step"] == pres["step"] == 3
    assert jtr.data_cursor == ptr.data_cursor == 3 * GB
    (js, jl), = jres["losses"]
    (ps, pl), = pres["losses"]
    assert js == ps == 3
    np.testing.assert_allclose(pl, jl, **TOL)
    # the step is stored as [1]; the JAX reader keeps that shape, the
    # port's restores the template's 0-d
    assert ptr.opt_state["step"].dtype == torch.int32
    assert ptr.opt_state["step"].shape == ()
    assert int(ptr.opt_state["step"]) == int(np.asarray(
        jtr.opt_state["step"]).reshape(())) == 3
    for got, want in ((ptr.params, jtr.params),
                      (ptr.opt_state["m"], jtr.opt_state["m"]),
                      (ptr.opt_state["v"], jtr.opt_state["v"])):
        want = dict(flatten_tree(_np(want)))
        for name, leaf in flatten_tree(got):
            assert leaf.dtype == torch.float32, name
            np.testing.assert_allclose(leaf.numpy(), want[name], **TOL,
                                       err_msg=name)


def _tree(rng):
    f = rng.standard_normal
    return {"params": {"embed": f((5, 3)).astype(np.float32),
                       "layers": {"w": f((2, 3, 2)).astype(np.float32),
                                  "ln1": np.ones((2, 3), np.float32)}},
            "opt": {"step": np.int32(7),
                    "ef": {"w": f((2, 3, 2)).astype(np.float32)},
                    "q": np.arange(-4, 4, dtype=np.int8)}}


def _as_jax(tree):
    """bfloat16 ``ef`` leaves, as the int8 compression state holds."""
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["opt"]["ef"] = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), out["opt"]["ef"])
    return out


def _as_torch(tree):
    out = {"params": jax.tree_util.tree_map(torch.from_numpy,
                                            tree["params"]),
           "opt": {"step": torch.tensor(7, dtype=torch.int32),
                   "ef": {"w": torch.from_numpy(tree["opt"]["ef"]["w"])
                          .to(torch.bfloat16)},
                   "q": torch.from_numpy(tree["opt"]["q"])}}
    return out


def test_same_tree_writes_byte_equal_shards_and_restores_across():
    tree = _tree(np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as td:
        ja, pa_ = os.path.join(td, "jax"), os.path.join(td, "port")
        JaxCheckpointManager(ja).save(4, _as_jax(tree), data_cursor=12,
                                      blocking=True)
        CheckpointManager(pa_).save(4, _as_torch(tree), data_cursor=12,
                                    blocking=True)
        shard = os.path.join("step_4", "shard_00000.bebop")
        with open(os.path.join(ja, shard), "rb") as f:
            jbytes = f.read()
        with open(os.path.join(pa_, shard), "rb") as f:
            assert f.read() == jbytes
        # each package restores the other's files
        got, man = CheckpointManager(ja).restore(4, _as_torch(tree))
        assert man["data_cursor"] == 12 and man["complete"] is True
        assert got["opt"]["ef"]["w"].dtype == torch.bfloat16
        assert got["opt"]["step"].dtype == torch.int32
        assert got["opt"]["q"].dtype == torch.int8
        jgot, jman = JaxCheckpointManager(pa_).restore(4, _as_jax(tree))
        assert jman["data_cursor"] == 12
        want = dict(flatten_tree(_as_torch(tree)))
        for name, leaf in flatten_tree(got):
            assert torch.equal(leaf, want[name]), name
        for name, leaf in flatten_tree(jgot):
            np.testing.assert_array_equal(_f32(leaf), _f32(want[name]),
                                          err_msg=name)


_NO_ML_DTYPES = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
from repro_torch.checkpoint import CheckpointManager

out_dir, jax_dir = sys.argv[1], sys.argv[2]
w = torch.tensor([[1.0, -2.5, 3.140625], [1e-3, 65280.0, -0.0]],
                 dtype=torch.bfloat16)
tree = {"w": w, "n": {"b": w[0].clone()}}
mgr = CheckpointManager(out_dir)
mgr.save(1, tree, blocking=True)
got, _ = mgr.restore(1, tree)
assert got["w"].dtype == torch.bfloat16
assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
assert torch.equal(got["n"]["b"].view(torch.int16), w[0].view(torch.int16))
# a file the JAX package wrote, whose bfloat16 leaf is the same numbers
got, _ = CheckpointManager(jax_dir).restore(1, tree)
assert got["w"].dtype == torch.bfloat16
assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
assert "ml_dtypes" not in sys.modules
print("ok")
"""


def test_bf16_round_trips_with_ml_dtypes_blocked():
    w = jnp.asarray([[1.0, -2.5, 3.140625], [1e-3, 65280.0, -0.0]],
                    dtype=jnp.bfloat16)
    with tempfile.TemporaryDirectory() as td:
        jdir = os.path.join(td, "jax")
        JaxCheckpointManager(jdir).save(1, {"w": w, "n": {"b": w[0]}},
                                        blocking=True)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.dirname(repro_torch.__file__)))
        out = subprocess.run(
            [sys.executable, "-c", _NO_ML_DTYPES, os.path.join(td, "port"),
             jdir], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_checkpoint_atomic_roundtrip_and_retention():
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, tree, data_cursor=step * 100, blocking=True)
        assert mgr.steps() == [2, 3]  # retention
        out, man = mgr.restore(3, tree)
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"]["c"], tree["b"]["c"])
        assert man["data_cursor"] == 300
        assert man["complete"] is True


def test_checkpoint_crash_leaves_no_partial():
    with tempfile.TemporaryDirectory() as td:
        CheckpointManager(td)
        # simulate a crash: tmp dir exists, no manifest rename happened
        os.makedirs(os.path.join(td, ".tmp_step_9"))
        mgr2 = CheckpointManager(td)  # next run GCs tmp
        assert mgr2.latest_step() is None
        assert not os.path.exists(os.path.join(td, ".tmp_step_9"))


def test_checkpoint_corruption_detected():
    tree = {"a": torch.arange(100, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, tree, blocking=True)
        shard = os.path.join(td, "step_1", "shard_00000.bebop")
        data = bytearray(open(shard, "rb").read())
        data[-20] ^= 0xFF
        open(shard, "wb").write(bytes(data))
        with pytest.raises(Exception, match="CRC"):
            mgr.restore(1, tree)


def test_async_save_snapshots_before_returning():
    """The trainer updates its tensors in place right after ``save``: the
    background write must hold the values at the call."""
    w = torch.arange(6, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, {"w": w})
        w.add_(100)
        mgr.wait()
        out, _ = mgr.restore(1, {"w": w}, device="cpu")
    assert torch.equal(out["w"], torch.arange(6, dtype=torch.float32))


def test_restore_keeps_stored_dtypes():
    """Moments stay float32 and the step int32 whatever the template's
    leaves are (no cast to the model dtype)."""
    tree = {"m": torch.ones(3), "step": torch.tensor(5, dtype=torch.int32),
            "p": torch.ones(3, dtype=torch.bfloat16)}
    template = {k: torch.zeros(v.shape, dtype=torch.float16)
                for k, v in tree.items()}
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, tree, blocking=True)
        out, _ = mgr.restore(1, template)
    assert {k: v.dtype for k, v in out.items()} == {
        k: v.dtype for k, v in tree.items()}
    assert out["step"].shape == () and int(out["step"]) == 5


def test_trainer_checkpoint_holds_the_jax_tree_names():
    """The port's ``Trainer`` writes ``opt/{m,v}/<param path>``,
    ``opt/step`` and ``params/<param path>``, the names JAX's writes."""
    cfg = reduced_config(get_config("qwen2-1.5b"))
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(
        "qwen2-1.5b")))
    with tempfile.TemporaryDirectory() as td:
        tr = Trainer(cfg, OptimizerConfig(compression="int8"),
                     TrainConfig(steps=0, ckpt_dir=td), data=iter(()),
                     device="cpu")
        tr.run()
        names = [n for n, _ in flatten_tree(
            {"params": tr.params, "opt": tr.opt_state})]
    jt = JaxTrainer(jcfg, JaxOptimizerConfig(compression="int8"),
                    JaxTrainConfig(steps=0), data=iter(()))
    jt.watchdog.stop()
    jt.preemption.uninstall()
    jnames = ["/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  {"params": jt.params, "opt": jt.opt_state})[0]]
    assert names == jnames

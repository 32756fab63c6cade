"""The model's DTensor steps (``repro_torch/models/sharded.py``) on real
values, held to the plain model on the CPU.

Each reduced arch's params are placed by ``param_specs`` and its batch by
``batch_specs``; the logits, ``loss_and_grads``, prefill and a decode
step into the cache placed by ``cache_specs`` run on DTensors and are
held to the same steps on plain tensors at rtol 1e-4 and atol 3e-5 times
the largest magnitude of the plain tensor (at least 1): a gradient as
large as rwkv6's embedding's (11.3) differs by the rounding of sums split
over two ranks.

* One rank, in process: a (1, 1) mesh over a one-rank gloo group, with
  one and two microbatches.
* Two ranks: this file run as a script by two processes of one gloo
  group, on meshes (1, 2) (tensor-parallel: uneven heads, the
  vocab-parallel embedding and loss, a sequence-split cache) and (2, 1)
  (the batch split: MoE rows, the scans' shared parameters), with two
  microbatches, so the collectives are real::

      PYTHONPATH=src python tests/test_torch_sharded.py RANK PORT OUT ARCH...

  Rank 0 writes the names it compared to OUT, as JSON.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint.format import flatten_tree
from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import get_model
from repro_torch.train.train_loop import loss_and_grads

ATOL, RTOL = 3e-5, 1e-4
B, T, CACHE = 4, 8, 16
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _check(name, got, want, done):
    assert isinstance(got, DTensor), name
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    torch.testing.assert_close(_full(got), want, atol=ATOL * scale,
                               rtol=RTOL, msg=lambda m: f"{name}: {m}")
    done.append(name)


def run(arch, mesh, accum, done):
    """Every step of ``arch`` on DTensors placed on ``mesh`` against the
    plain steps; appends the names compared to ``done``."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              attention_impl="reference")
    model = get_model(cfg)
    params = model.init(0, torch.device("cpu"))
    dparams = S.distribute(params, mesh, S.param_specs(cfg, params, mesh))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                              .astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                              .astype(np.int32))
    labels[0, :3] = -1                                  # ignored positions
    batch = {"tokens": tokens, "labels": labels}
    specs = S.batch_specs(cfg, ShapeConfig("t", T, B, "train"), mesh)
    dbatch = S.distribute(batch, mesh, specs)
    tag = f"{arch}/{tuple(mesh.shape)}/accum{accum}"

    loss, grads = loss_and_grads(model, params, batch, accum)
    logits, cache = model.prefill(params, {"tokens": tokens}, CACHE)
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    step, cache = model.decode_step(params, nxt, cache, T)
    with implicit_replication():
        dlogits_all = model.logits(dparams, {"tokens": dbatch["tokens"]})
        dloss, dgrads = loss_and_grads(model, dparams, dbatch, accum)
        dlogits, dcache = model.prefill(dparams,
                                        {"tokens": dbatch["tokens"]}, CACHE)
        dcache = S.distribute(dcache, mesh, S.cache_specs(cfg, dcache, mesh))
        dnxt = S.distribute({"tokens": nxt}, mesh,
                            {"tokens": specs["tokens"]})["tokens"]
        dstep, dcache = model.decode_step(dparams, dnxt, dcache, T)
    _check(f"{tag}/logits", dlogits_all,
           model.logits(params, {"tokens": tokens}), done)
    _check(f"{tag}/loss", dloss, loss, done)
    dgrads = dict(flatten_tree(dgrads))
    for name, g in flatten_tree(grads):
        _check(f"{tag}/grad/{name}", dgrads[name], g, done)
    _check(f"{tag}/prefill", dlogits, logits, done)
    _check(f"{tag}/decode", dstep, step, done)
    dcache = dict(flatten_tree(dcache))
    for name, c in flatten_tree(cache):
        _check(f"{tag}/cache/{name}", dcache[name], c, done)


ARCHS = ("qwen2-moe-a2.7b", "rwkv6-7b", "recurrentgemma-9b")


@pytest.fixture(scope="module")
def one_rank():
    """The (1, 1) CPU mesh over a one-rank gloo group, destroyed after."""
    assert not dist.is_initialized()
    m = make_host_mesh(device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_steps_equal_plain(one_rank, arch, accum):
    done = []
    run(arch, one_rank, accum, done)
    assert len(done) > 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TWO_RANK_ARCHS = ("gemma-2b",) + ARCHS


@pytest.fixture(scope="module")
def two_ranks():
    """The names the two ranks compared, every arch in one run."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "done.json")
        procs = [subprocess.Popen([sys.executable, __file__, str(r),
                                   str(port), out, *TWO_RANK_ARCHS],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        with open(out) as f:
            return json.load(f)


@pytest.mark.parametrize("arch", TWO_RANK_ARCHS)
def test_two_rank_steps_equal_plain(two_ranks, arch):
    for shape in ((1, 2), (2, 1)):
        tag = f"{arch}/{shape}/accum2"
        for part in ("logits", "loss", "prefill", "decode", "grad/embed",
                     "cache/"):
            assert any(n.startswith(f"{tag}/{part}") for n in two_ranks), \
                (tag, part)


def main():
    rank, port, out, archs = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4:])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    done = []
    try:
        for arch in archs:
            for shape in ((1, 2), (2, 1)):
                run(arch, make_mesh(shape, ("data", "model"), device="cpu"),
                    2, done)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(done, f)


if __name__ == "__main__":
    main()

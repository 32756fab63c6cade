"""The paged batcher's greedy pick on the device, on the CPU and the card.

* **Ties.**  ``_greedy_ids`` over bf16 logits ``[B, V]`` and ``[B, C, V]``
  with equal maxima planted at several positions (far apart, side by side,
  at both ends, +0 against -0, a constant row) returns what the host path
  returned: ``argmax`` over ``_widen(_fetch_logits(...))``, the first of
  the equal maxima.  The card case (``test_cuda_...``, skipped without a
  card) runs at a verify step's full width, ``[64, 5, 151936]``.
* **What crosses.**  A batch of greedy, sampled and ``n = 3`` forked
  requests with spec decode on, spans on: each ``step.logits`` span's
  ``host_rows`` is the step's sampled rows, ``device_rows`` the rest of
  its real rows, and ``bytes`` the ids plus those rows' logits.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.serving import Engine, PagedBatcher, SamplingParams, \
    ServeConfig
from repro_torch.serving.engine import _fetch_logits, _greedy_ids, _widen
from repro_torch.utils import spans


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planted(shape, seed):
    """bf16 logits of ``shape`` whose rows each hold a planted maximum at
    two to five positions, and the first of them."""
    rng = np.random.default_rng(seed)
    v = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    rows = x.reshape(-1, v)
    first = np.empty(len(rows), np.int64)
    for i, row in enumerate(rows):
        kind = i % 5
        if kind == 0:       # far apart, across any reduction's blocks
            at = rng.choice(v, rng.integers(2, 6), replace=False)
        elif kind == 1:     # side by side
            j = rng.integers(0, v - 3)
            at = np.array([j, j + 1, j + 2])
        elif kind == 2:     # both ends
            at = np.array([0, v - 1])
        elif kind == 3:     # the last index and one just before it
            at = np.array([v - 2, v - 1])
        else:               # +0 and -0 over a row of negatives
            row[:] = -np.abs(row) - 1
            at = rng.choice(v, 4, replace=False)
            row[at] = [0.0, -0.0, 0.0, -0.0]
            first[i] = at.min()
            continue
        row[at] = 9.0 + (i % 3)     # exact in bf16, above every normal
        first[i] = at.min()
    rows[-1] = 0.5                  # a constant row: index 0
    first[-1] = 0
    return torch.from_numpy(x).to(torch.bfloat16), \
        first.reshape(shape[:-1])


def _host_pick(logits):
    """The host path's greedy choice: exactly widened values, np.argmax."""
    return _widen(_fetch_logits(logits.cpu())).argmax(-1)


@pytest.mark.parametrize("shape", [(8, 1000), (6, 5, 1000), (64, 4099)])
def test_device_pick_equals_the_host_pick_on_planted_ties(shape):
    logits, first = _planted(shape, seed=sum(shape))
    host = _host_pick(logits)
    np.testing.assert_array_equal(host, first)
    got = _greedy_ids(logits)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape[:-1]
    np.testing.assert_array_equal(got.numpy(), host)


def test_cuda_pick_keeps_the_first_of_equal_maxima(cuda):
    """CUDA ``argmax`` over a chat verify step's bf16 logits with planted
    equal maxima returns the host path's choice."""
    logits, first = _planted((64, 5, 151936), seed=29)
    host = _host_pick(logits)
    np.testing.assert_array_equal(host, first)
    got = _greedy_ids(logits.to(cuda))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), host)


SC = dict(cache_len=96, max_new_tokens=12, prefill_chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_only_the_sampled_rows_logits_cross(monkeypatch, dtype):
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-1.5b")),
                              dtype=dtype)
    engine = Engine(cfg, ServeConfig(**SC), device="cpu")
    rng = np.random.default_rng(29)
    loop = np.resize(rng.integers(0, 512, 3), 24).astype(np.int32)
    sp = SamplingParams(temperature=1.0, top_k=2, seed=5)
    reqs = [(loop, {}), (loop, {"sampling": sp}),
            (rng.integers(0, 512, 19).astype(np.int32), {}),
            (rng.integers(0, 512, 11).astype(np.int32),
             {"sampling": sp, "n": 3})]
    b = PagedBatcher(engine, max_batch=8)
    want = []         # each step's sampled rows, as the batcher sees them
    call = PagedBatcher._call_step

    def counted(self, *a, **kw):
        want.append(sum(r.rows for r in self._active
                        if not r.sampling.greedy))
        return call(self, *a, **kw)
    monkeypatch.setattr(PagedBatcher, "_call_step", counted)
    spans.enable()
    try:
        with b._cond:
            futs = [b.submit(t, **kw) for t, kw in reqs]
        out = [f.result(timeout=300) for f in futs]
        end = time.monotonic() + 60   # the last step records after its
        while (b._active or b._trace is not None) \
                and time.monotonic() < end:   # requests resolve
            time.sleep(0.005)
        got = spans.drain()["spans"]
    finally:
        spans.drain()
        b.close()
    assert out[3].shape == (3, SC["max_new_tokens"])
    steps = sorted((s for s in got if s.name == "batcher.step"),
                   key=lambda s: s.start)
    logits = {s.parent: s.attrs for s in got if s.name == "step.logits"}
    assert len(steps) == len(want)
    wide = 2 if dtype == "bfloat16" else 4
    for step, sampled in zip(steps, want):
        a, lg = step.attrs, logits[step.id]
        # a verify step scores every position, the others the last
        c = a["q_positions"] // b.max_batch if a["kind"] == "verify" else 1
        assert lg["host_rows"] == sampled
        assert lg["device_rows"] == a["decode_rows"] + a["prefill_rows"] \
            - sampled
        assert lg["bytes"] == 4 * b.max_batch * c \
            + sampled * c * cfg.vocab_size * wide
    kinds = {(s.attrs["kind"], logits[s.id]["host_rows"] > 0,
              logits[s.id]["device_rows"] > 0) for s in steps}
    assert {("mixed", True, True), ("verify", True, True)} <= kinds

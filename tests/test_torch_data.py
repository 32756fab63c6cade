"""The port's data pipeline against the JAX package's, on the CPU.

* ``synthetic_corpus``, ``pack_examples`` (fixed doc ids), the pages and
  ``decode_page`` / ``iter_example_batches`` bit-equal;
* ``Pipeline`` batches and cursors equal to JAX's on the same buffer: from
  the start, from a restart cursor, and per host under host sharding;
* ``device_batches`` payloads and cursors byte-equal;
* ``decode_page_device`` on a CPU tensor (the plain decode) equal to JAX's
  Pallas decode in interpret mode, and the decoded batch is the host's;
* hedged reads fire under a straggling source, as in the JAX test.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import pages as jpages
from repro.core.device import decode_page_device as jax_decode_page_device
from repro.data import BufferSource as JaxBufferSource
from repro.data import DataConfig as JaxDataConfig
from repro.data import Pipeline as JaxPipeline
from repro.data import device_batches as jax_device_batches
from repro.data import records as jrecords

from repro_torch.core import pages
from repro_torch.core.device import decode_page_device
from repro_torch.data import (BufferSource, DataConfig, Pipeline,
                              device_batches, example_layout,
                              iter_example_batches, pack_examples,
                              synthetic_corpus, train_example_struct,
                              write_example_pages)
from repro_torch.kernels import bebop_decode as bd

SEQ, VOCAB = 16, 512


@pytest.fixture(scope="module")
def data():
    toks = synthetic_corpus(SEQ, 130, VOCAB, seed=3)
    return toks, write_example_pages(SEQ, toks, records_per_page=8)


def test_records_and_pages_equal_jax(data):
    toks, buf = data
    np.testing.assert_array_equal(
        toks, jrecords.synthetic_corpus(SEQ, 130, VOCAB, seed=3))
    ids = np.arange(16 * 5, dtype=np.uint8).reshape(5, 16)
    recs = pack_examples(SEQ, toks[:5], doc_ids=ids)
    jrecs = jrecords.pack_examples(SEQ, toks[:5], doc_ids=ids)
    assert recs.tobytes() == jrecs.tobytes()
    s = train_example_struct(SEQ)
    assert pages.write_page(s.name, recs, first_record=7) == \
        jpages.write_page(s.name, jrecs, first_record=7)
    assert example_layout(SEQ).stride == jrecords.example_layout(SEQ).stride \
        == 16 + 4 * (SEQ + 1)
    # host decode of the whole buffer, page by page and by batch
    for off in pages.iter_pages(buf):
        assert pages.decode_page(s, buf, off).tobytes() == \
            jpages.decode_page(jrecords.train_example_struct(SEQ), buf,
                               off).tobytes()
    got = list(iter_example_batches(buf, SEQ, 6, cursor=9))
    want = list(jrecords.iter_example_batches(buf, SEQ, 6, cursor=9))
    assert [c for _, c in got] == [c for _, c in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _take(pipe, n):
    out = []
    for batch, cursor in pipe:
        out.append((batch, cursor))
        if len(out) == n:
            break
    pipe.stop()
    return out


@pytest.mark.parametrize("cursor", [0, 13])
def test_pipeline_batches_and_cursors_equal_jax(data, cursor):
    _, buf = data
    kw = dict(seq_len=SEQ, global_batch=4, records_per_page=8)
    got = _take(Pipeline(DataConfig(**kw), [BufferSource(buf)],
                         len(BufferSource(buf)), cursor=cursor), 100)
    want = _take(JaxPipeline(JaxDataConfig(**kw), [JaxBufferSource(buf)],
                             len(JaxBufferSource(buf)), cursor=cursor), 100)
    assert len(got) == len(want) == (130 - cursor) // 4
    for (b, c), (jb, jc) in zip(got, want):
        assert c == jc
        for k in ("tokens", "labels"):
            assert b[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], jb[k])


@pytest.mark.parametrize("host", [0, 1])
def test_pipeline_host_sharding_equals_jax(data, host):
    _, buf = data
    kw = dict(seq_len=SEQ, global_batch=8, num_hosts=2, host_index=host,
              records_per_page=8)
    got = _take(Pipeline(DataConfig(**kw), [BufferSource(buf)],
                         len(BufferSource(buf))), 100)
    want = _take(JaxPipeline(JaxDataConfig(**kw), [JaxBufferSource(buf)],
                             len(JaxBufferSource(buf))), 100)
    assert got and len(got) == len(want)
    for (b, c), (jb, jc) in zip(got, want):
        assert c == jc
        np.testing.assert_array_equal(b["tokens"], jb["tokens"])


@pytest.mark.parametrize("cursor", [0, 5, 40])
def test_device_batches_byte_equal(data, cursor):
    _, buf = data
    kw = dict(seq_len=SEQ, global_batch=6, records_per_page=8)
    got = list(device_batches(buf, DataConfig(**kw), cursor=cursor))
    want = list(jax_device_batches(buf, JaxDataConfig(**kw), cursor=cursor))
    assert got and len(got) == len(want)
    for (p, c), (jp, jc) in zip(got, want):
        assert c == jc and p.shape == (6, 16 + 4 * (SEQ + 1))
        assert p.tobytes() == jp.tobytes()


def test_decode_page_device_equals_jax_interpret(data):
    toks, buf = data
    dc = DataConfig(seq_len=SEQ, global_batch=16, records_per_page=8)
    payload, cursor = next(device_batches(buf, dc))
    layout = example_layout(SEQ)
    before = bd.decode_columns.launches
    cols = decode_page_device(torch.from_numpy(payload), layout)
    assert bd.decode_columns.launches == before    # the plain version
    want = jax_decode_page_device(jnp.asarray(payload),
                                  jrecords.example_layout(SEQ),
                                  impl="pallas")
    assert sorted(cols) == sorted(want) == ["doc_id", "tokens"]
    for name in cols:
        assert str(cols[name].dtype).split(".")[-1] == str(want[name].dtype)
        np.testing.assert_array_equal(cols[name].numpy(),
                                      np.asarray(want[name]))
    np.testing.assert_array_equal(cols["tokens"].numpy(),
                                  toks[:16].astype("<i4"))
    # the decoded batch is the host pipeline's batch for the same cursor
    (batch, c), = _take(Pipeline(dc, [BufferSource(buf)],
                                 len(BufferSource(buf))), 1)
    assert c == cursor == 16
    np.testing.assert_array_equal(cols["tokens"][:, :-1].numpy(),
                                  batch["tokens"])
    np.testing.assert_array_equal(cols["tokens"][:, 1:].numpy(),
                                  batch["labels"])


def test_decode_page_device_refuses_a_foreign_stride(data):
    from repro_torch.core import types as T
    with pytest.raises(T.DecodeError, match="stride"):
        decode_page_device(torch.zeros((2, 10), dtype=torch.uint8),
                           example_layout(SEQ))


def test_hedged_reads_fire_under_straggler(data):
    _, buf = data
    slow = BufferSource(buf, delay_s=0.8, delay_every=2)
    fast = BufferSource(buf)
    dc = DataConfig(seq_len=SEQ, global_batch=4, records_per_page=8,
                    hedge_after_s=0.05)
    pipe = Pipeline(dc, [slow, fast], len(slow))
    n = 0
    for _ in pipe:
        n += 1
        if n >= 6:
            break
    frac = pipe.hedged_fraction
    pipe.stop()
    assert frac > 0

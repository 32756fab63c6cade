"""The page-level inference handlers, called in process.

The JAX package serves ``Infer`` and ``ScorePage`` over its Bebop RPC
stack (``serving/service.py``).  The RPC stack is not ported yet; this
module keeps the page codecs and the bodies of the two handlers —
``_admit_tokens`` (header checks, device placement, kernel decode), then
submit-and-await on the batcher, or the engine's score — as
:meth:`InferenceImpl.infer`, which returns what the handler would put in
its ``InferResponse`` (``{"batch", "new_tokens", "page"}``), and
:meth:`InferenceImpl.score_page`, which returns the ``ScoreResponse``
(``{"scores"}``).  The response page is byte-identical to the JAX
handler's for the same tokens.
"""
from __future__ import annotations

import concurrent.futures as _cf
import threading
from typing import Dict, Optional

import numpy as np

from ..core import pages
from ..core import types as T
from ..core.rpc import RpcError, Status
from .engine import ContinuousBatcher, Engine, PagedBatcher, ShedError
from .ingest import PageIngest
from .sampling import GenerationParams

# -- page record schemas -------------------------------------------------------


def prompt_record_struct(seq_len: int) -> T.Struct:
    """One inference prompt row: ``struct PromptRecord{N} { tokens: u32[N] }``."""
    return T.Struct(f"PromptRecord{seq_len}", [
        T.Field("tokens", T.FixedArray(T.UINT32, seq_len)),
    ])


def gen_record_struct(new_tokens: int) -> T.Struct:
    """One generated row: ``struct GenRecord{N} { tokens: u32[N] }``."""
    return T.Struct(f"GenRecord{new_tokens}", [
        T.Field("tokens", T.FixedArray(T.UINT32, new_tokens)),
    ])


def encode_prompt_page(tokens: np.ndarray) -> bytes:
    """[B, T] tokens -> one PromptRecord page (the client-side encoder)."""
    tokens = np.atleast_2d(np.asarray(tokens))
    s = prompt_record_struct(tokens.shape[1])
    recs = np.zeros(tokens.shape[0], dtype=T.static_dtype(s))
    recs["tokens"] = tokens.astype("<u4")
    return pages.write_page(s.name, recs)


def encode_gen_page(tokens: np.ndarray) -> bytes:
    """[B, N] generated tokens -> one GenRecord page."""
    tokens = np.atleast_2d(np.asarray(tokens))
    s = gen_record_struct(tokens.shape[1])
    recs = np.zeros(tokens.shape[0], dtype=T.static_dtype(s))
    recs["tokens"] = tokens.astype("<u4")
    return pages.write_page(s.name, recs)


def decode_token_page(buf) -> np.ndarray:
    """Page of {Prompt,Gen}Record -> [B, N] uint32 (host view); an empty
    buffer is the zero-generated-tokens response: [0, 0]."""
    if len(buf) == 0:
        return np.zeros((0, 0), dtype="<u4")
    payload = pages.read_payload(buf)
    return np.ascontiguousarray(payload).view("<u4").reshape(
        payload.shape[0], payload.shape[1] // 4)


class InferenceImpl:
    """The page-level ``Infer`` and ``ScorePage`` paths over an
    :class:`Engine`.

    Owns a :class:`PageIngest` on the engine's device (which defaults to
    the card) and a batcher: the :class:`PagedBatcher` when the serve
    config asks for paging and the model family supports it, else the
    dense :class:`ContinuousBatcher`, as in JAX.
    """

    # Distinct prompt widths one service plans decodes for: the width is
    # client-controlled, so without a bound a client sweeping strides
    # would grow the plan cache without limit.
    MAX_PLAN_WIDTHS = 64

    def __init__(self, engine: Engine, *,
                 ingest: Optional[PageIngest] = None,
                 batcher: Optional[PagedBatcher] = None):
        self.engine = engine
        self.ingest = ingest or PageIngest(device=engine.device)
        if batcher is None:
            batcher = PagedBatcher(engine) \
                if engine.serve.paged and engine.supports_paged \
                else ContinuousBatcher(engine)
        self.batcher = batcher
        self._plan_lock = threading.Lock()
        self._known_seqs: Dict[int, bool] = {}

    def _ensure_plan(self, seq_len: int) -> None:
        """Register Prompt/Gen record plans for this width exactly once."""
        with self._plan_lock:
            if seq_len in self._known_seqs:
                return
            if len(self._known_seqs) >= self.MAX_PLAN_WIDTHS:
                raise RpcError(Status.RESOURCE_EXHAUSTED,
                               "too many distinct prompt widths")
            self.ingest.register(prompt_record_struct(seq_len))
            self.ingest.register(gen_record_struct(seq_len))
            self._known_seqs[seq_len] = True

    def _admit_tokens(self, buf, deadline) -> np.ndarray:
        """Prompt page -> [B, T] int32 via the device decode path."""
        if deadline is not None and deadline.expired():
            raise RpcError(Status.DEADLINE_EXCEEDED, "deadline expired")
        if buf is None or len(buf) == 0:
            raise RpcError(Status.INVALID_ARGUMENT, "missing page payload")
        try:
            header = pages.read_header(buf)
            if header.record_stride % 4 or header.record_stride == 0:
                raise pages.PageError(
                    f"prompt stride {header.record_stride} is not a "
                    f"positive multiple of 4 (u32 tokens)")
            if header.record_count == 0:
                raise pages.PageError("page holds zero records")
            seq_len = header.record_stride // 4
            if seq_len > self.engine.serve.cache_len:
                raise pages.PageError(
                    f"prompt length {seq_len} exceeds engine cache "
                    f"{self.engine.serve.cache_len}")
            self._ensure_plan(seq_len)
            admitted = self.ingest.admit(buf, deadline=deadline)
        except pages.PageError as e:
            code = Status.DEADLINE_EXCEEDED if "deadline" in str(e) \
                else Status.INVALID_ARGUMENT
            raise RpcError(code, f"bad page: {e}") from e
        # the scheduler plans on the host (prefix hashes, drafts), as the
        # JAX handler's np.asarray does
        return admitted.columns["tokens"].cpu().numpy()

    def _await(self, fut: _cf.Future, deadline) -> np.ndarray:
        timeout = None
        if deadline is not None:
            timeout = max(deadline.remaining(), 0.0) + 1.0
        try:
            return fut.result(timeout=timeout)
        except ShedError as e:
            code = Status.DEADLINE_EXCEEDED if "deadline" in str(e) \
                else Status.RESOURCE_EXHAUSTED
            raise RpcError(code, str(e)) from e
        except _cf.TimeoutError:
            raise RpcError(Status.DEADLINE_EXCEEDED,
                           "deadline expired waiting for batch slot") from None

    def infer(self, page: bytes, *, max_new_tokens: Optional[int] = None,
              deadline=None) -> dict:
        """Generate for every prompt row of ``page``; greedy.

        ``max_new_tokens`` absent means the handler default (16), as in
        the JAX ``Infer``; ``deadline`` is any object with ``expired()``
        and ``remaining()``.  Returns ``{"batch", "new_tokens", "page"}``
        where ``page`` is a GenRecord page (empty bytes when zero tokens
        were generated).
        """
        tokens = self._admit_tokens(page, deadline)
        req = {} if max_new_tokens is None \
            else {"max_new_tokens": max_new_tokens}
        gp = GenerationParams.from_request(req)
        out = self._await(self.batcher.submit(tokens, params=gp,
                                              deadline=deadline), deadline)
        return {"batch": out.shape[0], "new_tokens": out.shape[1],
                "page": encode_gen_page(out) if out.shape[1] else b""}

    def score_page(self, page: bytes, *, deadline=None) -> dict:
        """Mean log-prob of every token row of ``page`` (the ``ScorePage``
        body: it chains after ``Infer``).  Returns ``{"scores": float32
        [B]}``; fewer than 2 tokens a row is ``INVALID_ARGUMENT``."""
        tokens = self._admit_tokens(page, deadline).astype(np.int32)
        if tokens.shape[1] < 2:
            raise RpcError(Status.INVALID_ARGUMENT,
                           "scoring needs at least 2 tokens per row")
        return {"scores": self.engine.score(tokens).astype(np.float32)}

    def close(self) -> None:
        self.batcher.close()

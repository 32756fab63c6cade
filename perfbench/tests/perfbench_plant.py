"""Faults planted under the timed path, for the tests that see a run with
one come out not correct: ``stale_pool``, a step that returns the K/V
pool as it was before the step; ``altered_token``, each token the batcher
picks moved to the next id."""


def plant(monkeypatch, fault: str) -> None:
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving.engine import PagedBatcher
    if fault == "stale_pool":
        def frozen(fn):
            def call(self, params, tokens, pool, *rest):
                out, _ = fn(self, params, tokens,
                            {k: v.clone() for k, v in pool.items()}, *rest)
                return out, pool
            return call
        for name in ("paged_step", "paged_step_verify"):
            monkeypatch.setattr(DecoderLM, name,
                                frozen(getattr(DecoderLM, name)))
    elif fault == "altered_token":
        pick = PagedBatcher._next_from

        def altered(self, req, logits, index):
            tok = pick(self, req, logits, index)
            return ((tok + 1) % logits.shape[-1]).astype(tok.dtype)
        monkeypatch.setattr(PagedBatcher, "_next_from", altered)
    else:
        raise ValueError(f"no fault {fault!r}")

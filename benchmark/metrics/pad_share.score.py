"""Share of rank 0's token slots that were padding, over every batch of the
stream: 1 - ``score.tokens_real`` / ``score.tokens_padded``, the program's
counters (``tokens_padded`` counts every slot of a batch, as
``serve.tokens_padded`` does a pack's)."""


def read(run):
    counters = (run.get("program") or {}).get("counters") or {}
    real, slots = counters.get("score.tokens_real"), counters.get("score.tokens_padded")
    if real is None or not slots:
        return None
    return 100.0 * (slots - real) / slots

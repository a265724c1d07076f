"""Share of the window's batches, in %, for which the data feed's queue was
empty when the step asked: the program's ``train.feed_empty`` counter over
``train.feed_batches``, both counted while the traced window's profiler ran."""


def read(run):
    try:
        from sovits_tpu_torch.utils import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("train.feed_batches"):
        return None
    return 100.0 * c.get("train.feed_empty", 0) / c["train.feed_batches"]

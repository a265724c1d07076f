"""Milliseconds the data feed's thread took to build each batch the window
took: the program's ``train.feed_build_s`` counter over
``train.feed_batches``, both counted by the consumer while the traced
window's profiler ran."""


def read(run):
    try:
        from sovits_tpu_torch.utils import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("train.feed_batches") or "train.feed_build_s" not in c:
        return None
    return 1e3 * c["train.feed_build_s"] / c["train.feed_batches"]

"""Host milliseconds per step spent waiting on the next batch from the
program's prefetching iterator (``train/data.py``'s ``batch_iterator``)."""


def read(run):
    spans, steps = run.layer.get("spans"), run.layer.get("steps")
    if not spans or not steps or "data_wait" not in spans:
        return None
    return 1e3 * spans["data_wait"] / steps

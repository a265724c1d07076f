"""Chunks per synthesizer dispatch: the program's ``svc.chunks`` counter
(chunks through the front end) over ``svc.dispatches`` (batches the
synthesizer ran), both counted while the traced window's profiler ran."""


def read(run):
    try:
        from sovits_tpu_torch.utils import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("svc.chunks") or not c.get("svc.dispatches"):
        return None
    return c["svc.chunks"] / c["svc.dispatches"]

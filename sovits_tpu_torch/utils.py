"""Observability: spans and counters, profiler traces, stage timers
(counterpart of ``sovits_tpu/utils.py``).

Tracing is on while a ``torch.profiler`` window is open on the calling
thread: ``trace`` below, the benchmark's traced runs, or an operator's own
profiler. ``annotate`` opens a span, a ``record_function`` range named by a
dotted string (``svc.f0``), which lands on the trace's host timeline beside
the device's work; spans nest on their thread, and a take's all sit inside
its ``svc.slice_inference``. ``count`` adds to an in-memory counter,
``counters`` reads them. With no window open both cost one check of the
profiler's flag and record nothing.

``trace`` records a window (host and, on a CUDA machine, device activity)
and writes it under ``log_dir`` as a Chrome/Perfetto trace, with the
window's counters beside it. ``StageTimer`` accumulates wall-clock seconds
per stage, always on, with the JAX package's ``summary`` keys.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

_OFF = contextlib.nullcontext()
_counters: dict[str, float] = defaultdict(float)
_counters_lock = threading.Lock()


def annotate(name: str):
    """A span named ``name`` on the profiler's timeline while a profiler
    window is open on this thread; otherwise nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def annotated(name: str):
    """Decorator: each call of the function is an ``annotate(name)`` span."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler window is open on
    this thread."""
    if torch.autograd._profiler_enabled():
        with _counters_lock:
            _counters[name] += n


def counters() -> dict[str, float]:
    """A copy of every counter."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str | Path = "sovits_trace"):
    """Profile the block with the counters cleared first; write
    ``<log_dir>/trace-<pid>-<n>.json`` and the block's counters as
    ``<log_dir>/counters-<pid>-<n>.json``. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_counters()
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len(list(log_dir.glob("trace-*.json")))
    prof.export_chrome_trace(str(log_dir / f"trace-{os.getpid()}-{n}.json"))
    (log_dir / f"counters-{os.getpid()}-{n}.json").write_text(json.dumps(counters(), indent=2))


class StageTimer:
    """Accumulating wall-clock timers for pipeline stages; ``summary()``
    returns total, count and mean seconds per stage. Threads may share one
    (the HTTP API's request threads do)."""

    def __init__(self):
        self._acc = defaultdict(float)
        self._count = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._acc[name] += dt
                self._count[name] += 1

    def summary(self) -> dict:
        with self._lock:
            return {
                name: {
                    "total_s": self._acc[name],
                    "count": self._count[name],
                    "mean_s": self._acc[name] / max(self._count[name], 1),
                }
                for name in self._acc
            }

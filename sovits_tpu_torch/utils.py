"""Observability: profiler traces and stage timers (counterpart of
``sovits_tpu/utils.py``).

``trace`` records a ``torch.profiler`` trace (host and, on a CUDA machine,
device activity) and writes it under ``log_dir`` as a Chrome/Perfetto trace
(open it in Perfetto or ``chrome://tracing``). ``annotate`` names a region
in that timeline. ``StageTimer`` accumulates wall-clock seconds per stage,
with the JAX package's ``summary`` keys.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path = "sovits_trace"):
    """Profile the block; write ``<log_dir>/trace-<pid>-<n>.json``. Yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    n = len(list(log_dir.glob("trace-*.json")))
    prof.export_chrome_trace(str(log_dir / f"trace-{os.getpid()}-{n}.json"))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def _synchronize(block_on) -> None:
    """Wait for the current streams of the devices of the CUDA tensors in
    ``block_on`` (a tensor or a nested list/tuple/dict of them): the
    counterpart of ``jax.block_until_ready``. A stream runs in order, so
    this waits for all the work queued on it, the block's included."""
    if isinstance(block_on, torch.Tensor):
        if block_on.is_cuda:
            torch.cuda.current_stream(block_on.device).synchronize()
    elif isinstance(block_on, dict):
        for v in block_on.values():
            _synchronize(v)
    elif isinstance(block_on, (list, tuple)):
        for v in block_on:
            _synchronize(v)


class StageTimer:
    """Accumulating wall-clock timers for pipeline stages; ``summary()``
    returns total, count and mean seconds per stage. Threads may share one
    (the HTTP API's request threads do)."""

    def __init__(self):
        self._acc = defaultdict(float)
        self._count = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block; with ``block_on`` (CUDA tensors) wait for their
        devices' streams before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
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

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))

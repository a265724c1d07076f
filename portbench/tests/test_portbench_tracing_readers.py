"""The readers of the program's own spans and counters, on hand-made trace
events and counters: each sums host ranges only, and each returns None where
its span or counter is absent, as on a program that opens none."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

HERE = ROOT / "portbench"

SPAN_READERS = [  # (metric, span, what the reader divides by)
    ("slice_ms_per_audio_s.serve", "svc.slice", "audio_s"),
    ("f0_ms_per_audio_s.serve", "svc.f0", "audio_s"),
    ("units_wait_ms_per_audio_s.serve", "svc.units_wait", "audio_s"),
    ("h2d_ms.train", "train.to_device", "steps"),
]


def _reader(name):
    return harness.load_module(HERE / "metrics" / f"{name}.py", f"reader_test_{name}")


def _run(events=None, **layer):
    return SimpleNamespace(trace_events=events, layer=layer)


@pytest.mark.parametrize("metric, span, per", SPAN_READERS, ids=[m for m, _, _ in SPAN_READERS])
def test_span_readers_sum_host_ranges_only(metric, span, per):
    read = _reader(metric).read
    events = [{"ph": "X", "cat": "user_annotation", "name": span, "ts": 0, "dur": 1500.0, "tid": 1},
              {"ph": "X", "cat": "user_annotation", "name": span, "ts": 4000, "dur": 500.0, "tid": 1},
              {"ph": "X", "cat": "gpu_user_annotation", "name": span, "ts": 0, "dur": 9000.0, "tid": 7},
              {"ph": "X", "cat": "user_annotation", "name": span + "x", "ts": 0, "dur": 7000.0, "tid": 1},
              {"ph": "X", "cat": "kernel", "name": span, "ts": 10, "dur": 3000.0, "tid": 7}]
    assert read(_run(events, **{per: 4})) == pytest.approx(0.5)  # 2 ms over 4
    assert read(_run(events[2:], **{per: 4})) is None  # no host range of that name
    assert read(_run(None, **{per: 4})) is None
    assert read(_run(events, **{per: 0})) is None and read(_run(events)) is None


COUNTER_READERS = [  # (metric, counters, value)
    ("chunks_per_dispatch.serve", {"svc.chunks": 9, "svc.dispatches": 6, "svc.takes": 3}, 1.5),
    ("feed_build_ms.train", {"train.feed_batches": 4, "train.feed_build_s": 0.5, "train.feed_empty": 1}, 125.0),
    ("feed_empty_share.train", {"train.feed_batches": 4, "train.feed_build_s": 0.5, "train.feed_empty": 1}, 25.0),
]


@pytest.mark.parametrize("metric, counted, value", COUNTER_READERS, ids=[m for m, _, _ in COUNTER_READERS])
def test_counter_readers(metric, counted, value, monkeypatch):
    from sovits_tpu_torch import utils

    read = _reader(metric).read
    monkeypatch.setattr(utils, "counters", lambda: dict(counted))
    assert read(_run()) == pytest.approx(value)
    monkeypatch.setattr(utils, "counters", dict)  # nothing counted
    assert read(_run()) is None
    monkeypatch.delattr(utils, "counters")  # a program without counters
    assert read(_run()) is None


def test_counter_readers_read_the_programs_window():
    """The program's own counters, counted only while a profiler runs."""
    from sovits_tpu_torch import utils

    utils.reset_counters()
    utils.count("svc.chunks", 5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        utils.count("svc.chunks", 3)
        utils.count("svc.dispatches", 2)
    assert _reader("chunks_per_dispatch.serve").read(_run()) == 1.5
    utils.reset_counters()
    assert _reader("chunks_per_dispatch.serve").read(_run()) is None

"""On the card: the control (the plain reference computed in TF32, the
precision below the configurations' float32 with TF32 off, put in the
program's place) fails the cells' limits, and the program on the same seed
passes them, at the cells' widths with fewer takes and rows than a run."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.run import set_precision

    return set_precision


def _run(cell: str, **traffic) -> harness.Run:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload, cfg, t, limits = harness.cell_files(ROOT, bench, cell)
    t.update(traffic)
    return harness.Run(workload, cfg, t, limits, 2**31 + 77, 0.0, False, "cuda")


def _held(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in readings)


@pytest.mark.parametrize("cell", ["serve.default", "serve.vol-tflow"])
def test_serving_control_fails_and_program_passes(card, cell):
    run = _run(cell, pool=4, take_seconds=[6, 12], check_takes=2)
    card()
    out = harness.driver(run.traffic).calibrate(run)
    assert _held(out["program"], run.limits), out
    assert not _held(out["control"], run.limits), out


@pytest.mark.parametrize("cell", ["train.default", "train.vol-tflow"])
def test_training_control_fails_and_program_passes(card, cell):
    run = _run(cell, batch=6, frames=400, utterances=18, utterance_seconds=[3, 6])
    card()
    out = harness.driver(run.traffic).calibrate(run)
    assert _held(out["program"], run.limits), out
    assert not _held(out["control"], run.limits), out
    assert not _held(out["half_batch"], run.limits), out

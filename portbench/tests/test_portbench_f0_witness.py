"""A second witness for the takes' timbre: with strong upper partials
(1, 0.5, 0.3, 0.2), WORLD DIO itself, at so-vits-svc's settings, marks a
fifth or more of the voiced frames of some takes unvoiced. The witness is
the JAX package's float64 NumPy DIO + StoneMask, written from WORLD's
published algorithm (loaded by its path: it imports only numpy and scipy).
The program's full-rate native DIO agrees with it to the frame, and with
the takes' own partials (1, 0.25, 0.1) neither unvoices a frame. CPU only;
no run of the benchmark loads that file."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import signals  # noqa: E402

HOP = 512
SETTINGS = dict(f0_floor=50.0, f0_ceil=1100.0, channels_in_octave=2.0,
                frame_period=1000.0 * HOP / signals.SR, allowed_range=0.1)


def _oracle():
    spec = importlib.util.spec_from_file_location("portbench_world_dio_witness",
                                                  ROOT / "sovits_tpu" / "f0" / "world_dio.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unvoiced_share(f0: np.ndarray, clip: signals.Clip) -> tuple[int, int]:
    true = clip.f0_at(np.arange(len(f0)) * HOP, margin=3 * HOP)
    inside = ~np.isnan(true)
    return int(np.sum(f0[inside] <= 0)), int(inside.sum())


@pytest.mark.parametrize("partials,least,most", [
    ((1.0, 0.5, 0.3, 0.2), 0.15, 1.0),
    (signals.PARTIALS, 0.0, 0.01),
])
def test_dio_unvoices_strong_partials_in_the_oracle_and_the_program(monkeypatch, partials, least, most):
    from sovits_tpu_torch.f0.dio import DioF0Predictor

    wd = _oracle()
    monkeypatch.setattr(signals, "PARTIALS", partials)
    layouts = signals.take_layouts(4, 6, 10, phrase_s=(1.5, 4))
    program = DioF0Predictor(hop_length=HOP, sampling_rate=signals.SR)
    program.exact = True
    off = {"oracle": 0, "program": 0}
    judged = 0
    for clip in signals.synthesize(layouts, 1, "cpu", 2):
        x = clip.audio.astype(np.float64)
        tpos, f0 = wd.dio(x, signals.SR, **SETTINGS)
        o, judged_here = _unvoiced_share(wd.stonemask(x, signals.SR, tpos, f0), clip)
        off["oracle"] += o
        off["program"] += _unvoiced_share(program.raw_f0(clip.audio, 0), clip)[0]
        judged += judged_here
    assert off["oracle"] == off["program"], off
    assert least <= off["oracle"] / judged <= most, (off, judged)

"""DIO + StoneMask, and Harvest, f0 through the port's native WORLD library
(counterpart of ``sovits_tpu/f0/dio.py``), with so-vits-svc's settings.

The default is the JAX package's default, the fast hybrid: two-stage
zero-phase polyphase decimation (fs/4 for StoneMask, fs/12 for the band
analysis at 44.1 kHz), float32 band filtering, native candidate scoring
and contour fixing, and StoneMask on the fs/4 signal. ``exact = True`` runs
DIO and StoneMask at the full rate in the native library: the path the
JAX package's tests hold to its float64 oracle. The two differ by about
0.006 Hz median, 0.04 Hz p95, with single frames about 10 Hz apart
(the JAX package's ``tests/test_f0.py::test_dio_fast_vs_exact_deviation``).
"""

from __future__ import annotations

import numpy as np

from .. import native
from .base import F0Predictor
from .world_dio import dio
from .world_harvest import harvest


class DioF0Predictor(F0Predictor):
    name = "dio"
    channels_in_octave = 2.0
    allowed_range = 0.1
    exact = False

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        fs = float(self.sampling_rate)
        kwargs = dict(
            frame_period=1000.0 * self.hop_length / fs, f0_floor=max(self.f0_min, 40.0),
            f0_ceil=self.f0_max, channels_in_octave=self.channels_in_octave,
            allowed_range=self.allowed_range,
        )
        wav = np.asarray(wav)
        if self.exact:
            tpos, f0 = native.world_dio(wav, fs, **kwargs)
            return native.world_stonemask(wav, fs, tpos, f0)
        if fs > 32000:
            r1, r2 = 4, 3
        elif fs > 16000:
            r1, r2 = 2, 2
        else:
            r1, r2 = 1, max(1, int(fs / 4000.0))
        y_sm = native.fir_decimate(wav, r1)  # StoneMask's signal, about 11 kHz
        y_band = native.fir_decimate(y_sm, r2)  # the band analysis', about 3.7 kHz
        tpos, f0 = dio(len(wav), fs, y_band, fs / (r1 * r2), **kwargs)
        return native.world_stonemask(y_sm, fs / r1, tpos, f0)


class HarvestF0Predictor(F0Predictor):
    """WORLD Harvest (``world_harvest.py``). The default is the JAX package's
    default: float32 band filtering with candidates, refinement and the
    reliability gate in the native library. ``exact = True`` runs the float64
    numpy path, the JAX package's oracle."""

    name = "harvest"
    exact = False

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        fs = float(self.sampling_rate)
        _tpos, f0 = harvest(wav, fs, f0_floor=max(self.f0_min, 40.0), f0_ceil=self.f0_max,
                            frame_period=1000.0 * self.hop_length / fs, use_native=not self.exact)
        return f0

"""DIO + StoneMask f0 through the repository's native WORLD library
(counterpart of ``sovits_tpu/f0/dio.py``).

It runs ``sovits_tpu.native.world_dio`` and ``world_stonemask`` at the full
sample rate, with so-vits-svc's DIO settings: the C++ path that the JAX
package's tests hold to its float64 numpy oracle. The library builds with
``make`` at first use; if it cannot, this raises.
"""

from __future__ import annotations

import numpy as np

from sovits_tpu import native

from .base import F0Predictor


class DioF0Predictor(F0Predictor):
    name = "dio"
    channels_in_octave = 2.0
    allowed_range = 0.1

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        if not native.world_available():
            raise RuntimeError("the native WORLD library (sovits_tpu/native) did not build")
        fs = float(self.sampling_rate)
        tpos, f0 = native.world_dio(
            wav, fs, frame_period=1000.0 * self.hop_length / fs,
            f0_floor=max(self.f0_min, 40.0), f0_ceil=self.f0_max,
            channels_in_octave=self.channels_in_octave, allowed_range=self.allowed_range,
        )
        return native.world_stonemask(wav, fs, tpos, f0)

"""F0 predictor interface + factory (counterpart of ``sovits_tpu/f0/base.py``).

Every predictor returns frame-rate f0 (len(wav) // hop frames) with
unvoiced gaps linearly interpolated, plus a voiced flag track.
"""

from __future__ import annotations

import numpy as np

from ..dsp.f0 import interpolate_unvoiced


class F0Predictor:
    name = "base"

    def __init__(self, hop_length: int = 512, sampling_rate: int = 44100,
                 f0_min: float = 50.0, f0_max: float = 1100.0, **kwargs):
        self.hop_length = hop_length
        self.sampling_rate = sampling_rate
        self.f0_min = f0_min
        self.f0_max = f0_max

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        """Per-frame f0 in Hz with 0 for unvoiced."""
        raise NotImplementedError

    def _postprocess(self, f0: np.ndarray, p_len: int):
        f0 = np.asarray(f0, dtype=np.float64)
        if len(f0) < p_len:
            f0 = np.pad(f0, (0, p_len - len(f0)))
        f0 = f0[:p_len]
        f0 = np.where((f0 < self.f0_min) | (f0 > self.f0_max), 0.0, f0)
        return interpolate_unvoiced(f0)

    def compute_f0(self, wav: np.ndarray, p_len: int | None = None) -> np.ndarray:
        return self.compute_f0_uv(wav, p_len)[0]

    def compute_f0_uv(self, wav: np.ndarray, p_len: int | None = None):
        if p_len is None:
            p_len = len(wav) // self.hop_length
        return self._postprocess(self.raw_f0(wav, p_len), p_len)


def get_f0_predictor(name: str, hop_length: int, sampling_rate: int, **kwargs) -> F0Predictor:
    """dio, harvest, pm and yin are ported; the f0 nets (crepe, rmvpe, fcpe)
    and unknown names raise."""
    from .dio import DioF0Predictor, HarvestF0Predictor
    from .praat import ParselmouthF0Predictor
    from .yin import YinF0Predictor

    registry = {"dio": DioF0Predictor, "harvest": HarvestF0Predictor,
                "pm": ParselmouthF0Predictor, "yin": YinF0Predictor}
    if name not in registry:
        raise NotImplementedError(f"f0 predictor {name!r} is not supported by the port "
                                  f"(use one of {sorted(registry)})")
    return registry[name](hop_length=hop_length, sampling_rate=sampling_rate, **kwargs)

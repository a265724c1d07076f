"""F0 predictor interface + factory (counterpart of ``sovits_tpu/f0/base.py``).

Every predictor returns frame-rate f0 (len(wav) // hop frames) with
unvoiced gaps linearly interpolated, plus a voiced flag track.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


def load_net(net: nn.Module, weights: dict | None, device: torch.device, what: str) -> nn.Module:
    """``net`` with ``weights`` loaded strictly, in eval mode on ``device``.

    ``weights`` is a state_dict in the published checkpoint's key names
    (tensors or numpy arrays); without it FileNotFoundError, as the JAX
    predictors raise: no checkpoint is looked up on disk."""
    if weights is None:
        raise FileNotFoundError(f"{what} weights not provided: pass weights=, the published "
                                "checkpoint's state_dict")
    net.load_state_dict({k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
                         for k, v in weights.items()}, strict=True)
    return net.to(device).eval()


def get_f0_predictor(name: str, hop_length: int, sampling_rate: int, **kwargs) -> F0Predictor:
    """All seven predictors of so-vits-svc (utils.py:88-109). The nets
    (crepe, rmvpe, fcpe) take ``weights=`` and ``device=`` (default
    "cuda"); the host predictors accept ``device`` and ignore it."""
    from .crepe import CrepeF0Predictor
    from .dio import DioF0Predictor, HarvestF0Predictor
    from .fcpe import FcpeF0Predictor
    from .praat import ParselmouthF0Predictor
    from .rmvpe import RmvpeF0Predictor
    from .yin import YinF0Predictor

    registry = {"dio": DioF0Predictor, "harvest": HarvestF0Predictor,
                "pm": ParselmouthF0Predictor, "yin": YinF0Predictor, "crepe": CrepeF0Predictor,
                "rmvpe": RmvpeF0Predictor, "fcpe": FcpeF0Predictor}
    if name not in registry:
        raise ValueError(f"unknown f0 predictor: {name}")
    return registry[name](hop_length=hop_length, sampling_rate=sampling_rate, **kwargs)

"""Feature interpolation and resampling (counterpart of ``sovits_tpu/dsp/audio.py``)."""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps


def repeat_expand(content: torch.Tensor, target_len: int, mode: str = "nearest") -> torch.Tensor:
    """Resample features [T, C] (or [B, T, C]) along time to target_len.

    'nearest' / 'left' hold the floor index; 'linear' is
    F.interpolate(align_corners=False). Positions are computed in float32,
    as the JAX package does, so both pick the same source frames.
    """
    src_len = content.shape[-2]
    pos = torch.arange(target_len, dtype=torch.float32, device=content.device)
    scale = torch.tensor(src_len / target_len, dtype=torch.float32, device=content.device)
    if mode in ("nearest", "left"):
        idx = torch.floor(pos * scale).long()
        return content.index_select(-2, idx)
    if mode == "linear":
        x = ((pos + 0.5) * scale - 0.5).clamp(0.0, src_len - 1)
        lo = torch.floor(x).long()
        hi = torch.clamp(lo + 1, max=src_len - 1)
        w = (x - lo).to(content.dtype)
        shape = [1] * content.dim()
        shape[-2] = target_len
        w = w.reshape(shape)
        return content.index_select(-2, lo) * (1 - w) + content.index_select(-2, hi) * w
    raise ValueError(f"unknown interpolation mode: {mode}")


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host-side polyphase (Kaiser FIR) resampling; float32 out."""
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = sps.resample_poly(np.asarray(audio, dtype=np.float64), up, down, axis=-1)
    return out.astype(np.float32)

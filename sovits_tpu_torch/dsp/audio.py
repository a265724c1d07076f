"""Feature interpolation, resampling and loudness-envelope mixing
(counterpart of ``sovits_tpu/dsp/audio.py``)."""

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


def rms_envelope(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """librosa.feature.rms-compatible RMS track (center=True, constant pad)."""
    y = np.asarray(y, dtype=np.float32)
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(yp[idx] ** 2, axis=-1))


def _interp_linear_1d(x: np.ndarray, target_len: int) -> np.ndarray:
    """F.interpolate(mode='linear', align_corners=False) on 1-D, in numpy."""
    src_len = len(x)
    pos = np.clip((np.arange(target_len) + 0.5) * (src_len / target_len) - 0.5, 0, src_len - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src_len - 1)
    w = pos - lo
    return x[lo] * (1 - w) + x[hi] * w


def change_rms(source: np.ndarray, source_sr: int, output: np.ndarray, output_sr: int,
               rate: float) -> np.ndarray:
    """Blend the output's loudness envelope toward the source's: rate 1 keeps
    the output's, rate 0 imposes the source's. Half-second RMS frames,
    linearly interpolated to the output's samples, then
    output * rms_source^(1 - rate) * rms_output^(rate - 1)."""
    rms1 = rms_envelope(source, source_sr // 2 * 2, source_sr // 2)
    rms2 = rms_envelope(output, output_sr // 2 * 2, output_sr // 2)
    rms1 = _interp_linear_1d(rms1, len(output))
    rms2 = np.maximum(_interp_linear_1d(rms2, len(output)), 1e-6)
    return output * (rms1 ** (1 - rate)) * (rms2 ** (rate - 1))

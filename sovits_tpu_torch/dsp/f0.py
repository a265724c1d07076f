"""F0 feature conversions (counterpart of ``sovits_tpu/dsp/f0.py``).

Tensor functions on the JAX layouts: f0 [B, T] in Hz, lf0 [B, T, 1],
masks [B, T, 1]. ``interpolate_unvoiced`` is host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Quantize f0 in Hz to [1, F0_BIN-1] integer bins; bin 1 is unvoiced."""
    f0_mel = 1127.0 * torch.log(1.0 + f0.float() / 700.0)
    a = (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN)
    b = F0_MEL_MIN * a - 1.0
    f0_mel = torch.where(f0_mel > 0, f0_mel * a - b, f0_mel)
    coarse = torch.round(f0_mel).long()
    coarse = coarse * (coarse > 0)
    coarse = coarse + (coarse < 1).long()
    # as in the JAX package: a bin past the top maps to 0, not to F0_BIN - 1
    coarse = coarse * (coarse < F0_BIN)
    return coarse + (coarse >= F0_BIN).long() * (F0_BIN - 1)


def f0_to_lf0(f0: torch.Tensor) -> torch.Tensor:
    """Hz -> scaled log-mel-Hz, the f0-decoder target."""
    return 2595.0 * torch.log10(1.0 + f0 / 700.0) / 500.0


def lf0_to_f0(lf0: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f0_to_lf0`."""
    return 700.0 * (torch.pow(10.0, lf0 * 500.0 / 2595.0) - 1.0)


def normalize_f0(lf0: torch.Tensor, x_mask: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Subtract the voiced-frame mean (inference: no random scale).

    lf0 [B, T, 1], x_mask [B, T, 1], uv [B, T] voiced flag.
    """
    uv_sum = uv.sum(dim=1, keepdim=True)
    uv_sum = torch.where(uv_sum == 0, torch.full_like(uv_sum, 9999.0), uv_sum)
    means = (lf0[..., 0] * uv).sum(dim=1, keepdim=True) / uv_sum  # [B, 1]
    return (lf0 - means[..., None]) * x_mask


def interpolate_unvoiced(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Linearly interpolate f0 over unvoiced gaps; return (f0, voiced flag)."""
    f0 = np.asarray(f0, dtype=np.float64)
    uv = (f0 == 0).astype(np.float32)
    voiced_idx = np.where(f0 > 0)[0]
    if len(voiced_idx) == 0:
        return f0.astype(np.float32), 1.0 - uv
    out = f0.copy()
    out[: voiced_idx[0]] = f0[voiced_idx[0]]
    out[voiced_idx[-1] + 1 :] = f0[voiced_idx[-1]]
    unvoiced_idx = np.where(out == 0)[0]
    if len(unvoiced_idx):
        out[unvoiced_idx] = np.interp(unvoiced_idx, voiced_idx, f0[voiced_idx])
    return out.astype(np.float32), 1.0 - uv

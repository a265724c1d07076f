"""Alias-free Snake activation (counterpart of ``sovits_tpu/nn/snake.py``;
so-vits-svc ``vdecoder/hifiganwithsnake/alias``).

SnakeBeta is x + sin^2(alpha x) / (beta + 1e-9) with per-channel alpha and
beta on a log scale. SnakeAlias wraps it between kaiser-windowed 2x up- and
downsampling so that the nonlinearity does not alias. The filters are host
constants (numpy, float64, normalised, then float32), held by each
SnakeAlias as non-persistent buffers; the resamplers are depthwise convs,
[B, C, T] channels-first.

Types: everything here computes in float32, whatever its input's type:
the filters and SnakeBeta's parameters are float32, and a bf16 input is
promoted with them, as numpy's rules promote it (and as the JAX SnakeBeta
does). The JAX ``upsample2x`` hands ``lax.conv_general_dilated`` a bf16
input with its float32 filter, which lax refuses rather than promotes, so
the JAX Snake generator runs only in float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """The kaiser-windowed sinc lowpass (julius' design): [kernel_size] float32 summing to 1."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


RATIO, TAPS = 2, 12  # so-vits-svc's Snake resamples 2x through 12-tap filters


def lowpass() -> torch.Tensor:
    """The resamplers' kaiser-sinc lowpass, [1, 1, TAPS] float32."""
    return torch.from_numpy(kaiser_sinc_filter1d(0.5 / RATIO, 0.6 / RATIO, TAPS))[None, None]


def upsample2x(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, 2T] float32: replicate pad, a depthwise
    transposed conv with the lowpass ``filt`` times 2, crop."""
    c = x.shape[1]
    x = x.float()
    pad = TAPS // RATIO - 1
    pad_left = pad * RATIO + (TAPS - RATIO) // 2
    pad_right = pad * RATIO + (TAPS - RATIO + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = RATIO * F.conv_transpose1d(x, filt.to(x.device).expand(c, 1, TAPS), stride=RATIO, groups=c)
    return y[..., pad_left : y.shape[-1] - pad_right]


def downsample2x(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, ceil(T / 2)] float32: replicate pad, a strided
    depthwise lowpass ``filt``."""
    c = x.shape[1]
    x = F.pad(x.float(), (TAPS // 2 - 1, TAPS // 2), mode="replicate")  # an even tap count
    return F.conv1d(x, filt.to(x.device).expand(c, 1, TAPS), stride=RATIO, groups=c)


class SnakeBeta(nn.Module):
    """x + sin^2(alpha x) / (beta + 1e-9), alpha = exp(alpha_param) and
    beta = exp(beta_param) per channel; both start at 0 (alpha = beta = 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.exp(self.alpha)[:, None]
        beta = torch.exp(self.beta)[:, None]
        return x + (1.0 / (beta + 1e-9)) * torch.square(torch.sin(x * alpha))


class SnakeAlias(nn.Module):
    """2x-oversampled SnakeBeta (so-vits-svc ``Activation1d``): its
    parameters are ``act.alpha`` / ``act.beta``."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.register_buffer("filter", lowpass(), persistent=False)  # both resamplers'

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample2x(self.act(upsample2x(x, self.filter)), self.filter)

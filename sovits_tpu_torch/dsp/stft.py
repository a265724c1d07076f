"""Linear and mel spectrograms through ``torch.stft`` (counterpart of
``sovits_tpu/dsp/stft.py``; so-vits-svc's ``mel_processing``).

Reflect pad by (n_fft - hop) / 2, centre-free STFT with a periodic Hann
window, magnitude sqrt(power + 1e-6); the mel projection is the Slaney
filterbank of ``dsp/mel.py`` followed by log(clamp(., 1e-5)). Outputs are
the JAX package's layout [B, T, F]. ``energy`` is the per-frame RMS volume
feature. Its rDFT-as-matmul is TPU layout work and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .mel import mel_filterbank


def hann_window(win_length: int, device) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s values), computed in
    float64 and returned as float32."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 * (1.0 - torch.cos(2.0 * np.pi * n / win_length))).float()


def spectrogram(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
                win_length: int = 2048) -> torch.Tensor:
    """Waveform [B, L] -> linear magnitude [B, T, 1 + n_fft // 2] (float32)."""
    pad = (n_fft - hop_length) // 2
    y = torch.nn.functional.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(y, n_fft, hop_length=hop_length, win_length=win_length,
                      window=hann_window(win_length, y.device), center=False, return_complex=True)
    return torch.sqrt(spec.real**2 + spec.imag**2 + 1e-6).transpose(1, 2)


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sample_rate: int, fmin: float,
                fmax: float) -> torch.Tensor:
    """Linear magnitude [B, T, F] -> log-mel [B, T, M]."""
    fbank = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(spec.device)
    return torch.log(torch.clamp(spec.float() @ fbank, min=1e-5))


def mel_spectrogram(y: torch.Tensor, n_fft: int = 2048, n_mels: int = 80,
                    sample_rate: int = 44100, hop_length: int = 512, win_length: int = 2048,
                    fmin: float = 0.0, fmax: float = 22050.0) -> torch.Tensor:
    """Waveform [B, L] -> log-mel [B, T, M]."""
    return spec_to_mel(spectrogram(y, n_fft, hop_length, win_length), n_fft, n_mels,
                       sample_rate, fmin, fmax)


def energy(y: torch.Tensor, hop_length: int = 512) -> torch.Tensor:
    """RMS per hop frame, the volume feature: audio [B, L] -> [B, L // hop].

    Square, reflect-pad by (hop // 2, (hop + 1) // 2), mean over
    non-overlapping hop windows truncated to L // hop frames, sqrt.
    """
    n_frames = y.shape[-1] // hop_length
    a2 = torch.nn.functional.pad(y.float()[:, None] ** 2,
                                 (hop_length // 2, (hop_length + 1) // 2), mode="reflect")[:, 0]
    blocks = a2[:, : n_frames * hop_length].reshape(y.shape[0], n_frames, hop_length)
    return torch.sqrt(blocks.mean(dim=-1))

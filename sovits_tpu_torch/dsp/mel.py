"""Log-mel spectrogram, the repository's measure of audio agreement.

Counterpart of ``sovits_tpu/dsp/mel.py`` (Slaney filterbank, identical to
``librosa.filters.mel``) and ``sovits_tpu/dsp/stft.py::mel_spectrogram``:
reflect pad by (n_fft - hop) / 2, centre-free STFT with a periodic Hann
window, magnitude sqrt(power + 1e-6), mel projection, log(clamp(., 1e-5)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    log_mel = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_mel, f / _F_SP)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), _F_SP * m)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney triangular filterbank [n_freqs, n_mels], float32."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(edges)
    ramps = edges[:, None] - fftfreqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (edges[2 : n_mels + 2] - edges[:n_mels]))[:, None]
    return np.ascontiguousarray(weights.T).astype(np.float32)


def mel_spectrogram(
    y: torch.Tensor,  # [B, L]
    n_fft: int = 2048,
    n_mels: int = 80,
    sample_rate: int = 44100,
    hop_length: int = 512,
    win_length: int = 2048,
    fmin: float = 0.0,
    fmax: float = 22050.0,
) -> torch.Tensor:
    """Waveform [B, L] -> log-mel [B, T, n_mels] (float32)."""
    pad = (n_fft - hop_length) // 2
    y = torch.nn.functional.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    n = torch.arange(win_length, dtype=torch.float64, device=y.device)
    window = (0.5 * (1.0 - torch.cos(2.0 * np.pi * n / win_length))).float()
    spec = torch.stft(y, n_fft, hop_length=hop_length, win_length=win_length, window=window,
                      center=False, return_complex=True)
    mag = torch.sqrt(spec.real**2 + spec.imag**2 + 1e-6).transpose(1, 2)  # [B, T, F]
    fbank = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(y.device)
    return torch.log(torch.clamp(mag @ fbank, min=1e-5))

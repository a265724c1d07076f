"""Mel filterbanks, identical to ``librosa.filters.mel`` (counterpart of
``sovits_tpu/dsp/mel.py``): the Slaney mel scale by default, the HTK scale
with ``htk=True`` (RMVPE's front end); Slaney area normalisation in both.
``dsp/stft.py`` projects spectrograms with it."""

from __future__ import annotations

import functools

import numpy as np

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


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asanyarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asanyarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False) -> np.ndarray:
    """Triangular filterbank [n_freqs, n_mels], float32."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    to_mel, to_hz = (_hz_to_mel_htk, _mel_to_hz_htk) if htk else (_hz_to_mel, _mel_to_hz)
    edges = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fdiff = np.diff(edges)
    ramps = edges[:, None] - fftfreqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (edges[2 : n_mels + 2] - edges[:n_mels]))[:, None]
    return np.ascontiguousarray(weights.T).astype(np.float32)

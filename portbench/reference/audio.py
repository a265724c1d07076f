"""so-vits-svc's host-side audio steps in NumPy and plain PyTorch: the
silence slicer (``inference/slicer.py``), ``slice_inference``'s padding,
trimming and joining, polyphase resampling, nearest-frame unit stretching,
the RMS volume feature, and the linear and mel spectrograms
(``mel_processing.py``, librosa's Slaney filterbank).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps


def rms_envelope(y, frame_length, hop_length):
    y = np.asarray(y, np.float32)
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(yp[idx] ** 2, axis=-1))


def slice_bounds(audio: np.ndarray, sr: int, db: float = -40.0, min_length=5000, min_interval=300,
                 hop_ms=20, max_sil_kept=5000) -> list[tuple[bool, int, int]]:
    """so-vits-svc's ``slicer.cut`` + ``chunks2audio``: [(is_silence, start, end), ...]."""
    threshold = 10 ** (db / 20.0)
    hop = round(sr * hop_ms / 1000)
    win = min(round(sr * min_interval / 1000), 4 * hop)
    min_len = round(sr * min_length / 1000 / hop)
    min_int = round(sr * min_interval / 1000 / hop)
    max_kept = round(sr * max_sil_kept / 1000 / hop)
    n = len(audio)
    if n <= min_len:
        return [(False, 0, n)]
    rms = rms_envelope(audio, win, hop)
    tags, sil_start, clip_start = [], None, 0
    for i, r in enumerate(rms):
        if r < threshold:
            if sil_start is None:
                sil_start = i
            continue
        if sil_start is None:
            continue
        leading = sil_start == 0 and i > max_kept
        if not leading and not (i - sil_start >= min_int and i - clip_start >= min_len):
            sil_start = None
            continue
        span = i - sil_start
        if span <= max_kept:
            pos = int(rms[sil_start:i + 1].argmin()) + sil_start
            tags.append((0, pos) if sil_start == 0 else (pos, pos))
            clip_start = pos
        elif span <= 2 * max_kept:
            pos = int(rms[i - max_kept:sil_start + max_kept + 1].argmin()) + i - max_kept
            pos_l = int(rms[sil_start:sil_start + max_kept + 1].argmin()) + sil_start
            pos_r = int(rms[i - max_kept:i + 1].argmin()) + i - max_kept
            if sil_start == 0:
                tags.append((0, pos_r))
                clip_start = pos_r
            else:
                tags.append((min(pos_l, pos), max(pos_r, pos)))
                clip_start = max(pos_r, pos)
        else:
            pos_l = int(rms[sil_start:sil_start + max_kept + 1].argmin()) + sil_start
            pos_r = int(rms[i - max_kept:i + 1].argmin()) + i - max_kept
            tags.append((0, pos_r) if sil_start == 0 else (pos_l, pos_r))
            clip_start = pos_r
        sil_start = None
    total = len(rms)
    if sil_start is not None and total - sil_start >= min_int:
        pos = int(rms[sil_start:min(total, sil_start + max_kept) + 1].argmin()) + sil_start
        tags.append((pos, total + 1))
    if not tags:
        return [(False, 0, n)]
    bounds = []
    if tags[0][0]:
        bounds.append((False, 0, min(n, tags[0][0] * hop)))
    for i, (s, e) in enumerate(tags):
        if i:
            bounds.append((False, tags[i - 1][1] * hop, min(n, s * hop)))
        bounds.append((True, s * hop, min(n, e * hop)))
    if tags[-1][1] * hop < n:
        bounds.append((False, tags[-1][1] * hop, n))
    return [(sil, a, b) for sil, a, b in bounds if a != b]


def pad_center(arr: np.ndarray, length: int) -> np.ndarray:
    n = len(arr)
    if n >= length:
        start = (n - length) // 2
        return arr[start:start + length]
    return np.pad(arr, ((length - n) // 2, length - n - (length - n) // 2))


def chunk_inputs(audio: np.ndarray, sr: int, pad_seconds: float = 0.5) -> list[np.ndarray]:
    """The padded voiced pieces ``slice_inference`` converts, in order (model rate = sr)."""
    pad = int(sr * pad_seconds)
    return [np.concatenate([np.zeros(pad), audio[a:b], np.zeros(pad)]).astype(np.float32)
            for sil, a, b in slice_bounds(audio, sr) if not sil]


def piece_length(n: int, sr: int, target_sr: int) -> int:
    """A piece's length at the model rate as so-vits-svc computes it,
    ``int(np.ceil(n / sr * target_sr))``: one sample more than n where the
    float quotient rounds up, even at equal rates."""
    return int(np.ceil(n / sr * target_sr))


def join(audio: np.ndarray, sr: int, converted: list[np.ndarray], pad_seconds: float = 0.5) -> np.ndarray:
    """``slice_inference``'s output from each voiced piece's converted audio
    (no forced clips, model rate = sr): silences as zeros, each piece's
    padding trimmed and the rest centred to the piece's length."""
    pad = int(sr * pad_seconds)
    parts, it = [], iter(converted)
    for sil, a, b in slice_bounds(audio, sr):
        n = piece_length(b - a, sr, sr)
        parts.append(np.zeros(n) if sil else pad_center(np.asarray(next(it))[pad:-pad], n))
    return np.concatenate(parts).astype(np.float32)


def out_length(audio: np.ndarray, sr: int) -> int:
    """The length of ``slice_inference``'s output for ``audio`` (model rate = sr)."""
    return sum(piece_length(b - a, sr, sr) for _, a, b in slice_bounds(audio, sr))


def resample(audio: np.ndarray, orig: int, target: int) -> np.ndarray:
    g = np.gcd(orig, target)
    return sps.resample_poly(np.asarray(audio, np.float64), target // g, orig // g).astype(np.float32)


def stretch(units: torch.Tensor, frames: int) -> torch.Tensor:
    """[T, C] -> [frames, C], each output frame taking the source frame at floor(t * T / frames)."""
    pos = torch.arange(frames, dtype=torch.float32, device=units.device)
    scale = torch.tensor(units.shape[0] / frames, dtype=torch.float32, device=units.device)
    return units[torch.floor(pos * scale).long()]


def volume(wav: np.ndarray, hop: int, frames: int) -> np.ndarray:
    """Per-frame RMS: squared audio reflect-padded by (hop // 2, (hop + 1) // 2), hop means."""
    a2 = np.pad(np.asarray(wav[:frames * hop], np.float64) ** 2, (hop // 2, (hop + 1) // 2), mode="reflect")
    return np.sqrt(a2[:frames * hop].reshape(frames, hop).mean(-1)).astype(np.float32)


def hann(n, device):
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 * (1.0 - torch.cos(2.0 * np.pi * k / n))).float()


def spectrogram(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """[B, L] -> magnitude [B, F, T]: reflect pad (n_fft - hop) / 2, no centring."""
    pad = (n_fft - hop) // 2
    y = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    s = torch.stft(y, n_fft, hop_length=hop, win_length=win, window=hann(win, y.device),
                   center=False, return_complex=True)
    return torch.sqrt(s.real ** 2 + s.imag ** 2 + 1e-6)


def mel_basis(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    """librosa.filters.mel (Slaney scale and norm): [n_mels, 1 + n_fft // 2]."""
    f_sp, min_hz = 200.0 / 3, 1000.0
    min_mel, step = min_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_hz, min_mel + np.log(np.maximum(f, 1e-10) / min_hz) / step, f / f_sp)

    def to_hz(m):
        return np.where(m >= min_mel, min_hz * np.exp(step * (m - min_mel)), f_sp * m)

    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    edges = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fdiff = np.diff(edges)
    ramps = edges[:, None] - freqs[None, :]
    w = np.maximum(0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (edges[2:] - edges[:-2]))[:, None]).astype(np.float32)


def spec_to_mel(spec: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """[B, F, T] -> log-mel [B, M, T]."""
    return torch.log(torch.clamp(basis @ spec, min=1e-5))

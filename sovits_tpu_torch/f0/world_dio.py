"""WORLD DIO on a pre-decimated signal (counterpart of the fast path of
``sovits_tpu/f0/world_dio.py::dio``), and the helpers that Harvest
(``world_harvest.py``) shares with it.

Band filtering runs here in numpy (overlap-save, float32); the event
tracks, candidate scoring and the four contour-fixing passes run in the
port's native library. The operations and their order are the JAX
package's, so both packages compute the same f0. The numpy helpers below
(decimation, event tracks, grouped instantaneous-frequency refinement) are
copies of the JAX package's: Harvest's float64 path runs them, and they are
the oracles of the native Harvest entry points.
"""

from __future__ import annotations

import numpy as np
from scipy import fft as sfft

from .. import native

EPS = 0.000000000001  # WORLD's kMySafeGuardMinimum
MAX_SCORE = 100000.0


def decimate(x: np.ndarray, ratio: int) -> np.ndarray:
    """MATLAB-style decimate as WORLD's matlabfunctions uses it: 8th-order
    Chebyshev-I (0.05 dB ripple) at 0.8*nyquist/ratio, zero-phase
    (filtfilt), every ratio-th sample."""
    if ratio == 1:
        return x.copy()
    from scipy import signal as sps

    b, a = sps.cheby1(8, 0.05, 0.8 / ratio)
    return sps.filtfilt(b, a, x)[::ratio]


def _suitable_fft_size(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def nuttall_window(n: int) -> np.ndarray:
    """Nuttall window as WORLD defines it (continuous first derivative)."""
    t = np.arange(n, dtype=np.float64) * (1.0 / max(n - 1, 1))
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t) + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


def _highpass_fir(fs: float) -> tuple[np.ndarray, int]:
    """WORLD's 50 Hz low-cut: inverted normalised Hanning lowpass plus a
    delta. Returns (fir, centre tap)."""
    cutoff_in_sample = int(round(fs / 50.0))
    n = cutoff_in_sample * 2 + 1
    k = np.arange(1, n + 1, dtype=np.float64)
    lowpass = 0.5 - 0.5 * np.cos(2 * np.pi * k / (n + 1))
    lowpass /= lowpass.sum()
    highpass = -lowpass
    highpass[cutoff_in_sample] += 1.0
    return highpass, cutoff_in_sample


def band_filtered_signals(y: np.ndarray, boundaries: np.ndarray, fs: float) -> list[np.ndarray]:
    """Low-cut and band-pass the DC-removed signal around each boundary f0
    (Nuttall window times a cosine carrier), delay-compensated, float32.

    Overlap-save: the 50 Hz highpass is folded into each band FIR in the
    frequency domain, the signal's block FFTs are computed once and shared
    by every band."""
    dtype = np.float32
    y = y - y.mean()
    y_length = len(y)
    hp, cutoff = _highpass_fir(fs)
    halves = [int(round(fs / b / 2.0)) for b in boundaries]
    l_max = len(hp) + 4 * max(halves) - 1  # longest combined FIR
    n_blk = _suitable_fft_size(4 * l_max)
    step = n_blk - l_max + 1

    firs = np.zeros((len(boundaries), n_blk), dtype)
    for b, boundary_f0 in enumerate(boundaries):
        n = halves[b] * 4
        carrier = np.cos(2 * np.pi * boundary_f0 * np.arange(n) / fs)
        firs[b, :n] = (nuttall_window(n) * carrier).astype(dtype)
    g_spec = sfft.rfft(firs, axis=1, workers=-1)
    g_spec *= sfft.rfft(hp.astype(dtype), n_blk, workers=-1)[None, :]

    total_out = y_length + cutoff + 2 * max(halves)
    n_blocks = -(-total_out // step)
    z = np.zeros((l_max - 1) + (n_blocks - 1) * step + n_blk, dtype)
    z[l_max - 1 : l_max - 1 + y_length] = y
    idx = np.arange(n_blk)[None, :] + (np.arange(n_blocks) * step)[:, None]
    block_spec = sfft.rfft(z[idx], axis=1, workers=-1)

    out = []
    for b, h in enumerate(halves):
        filt = sfft.irfft(block_spec * g_spec[b], n_blk, axis=1, workers=-1)
        lin = filt[:, l_max - 1 :].reshape(-1)
        # compensate the highpass delay (cutoff) and the band FIR delay (2 half)
        out.append(np.ascontiguousarray(lin[cutoff + 2 * h : cutoff + 2 * h + y_length]))
    return out


def _crossing_events(s: np.ndarray, idx: np.ndarray, fs: float):
    """Refine crossing sample indices -> (interval midpoints [s], f0 [Hz])."""
    if len(idx) < 2:
        return np.empty(0), np.empty(0)
    fine = idx + s[idx] / (s[idx] - s[idx + 1] + EPS)
    intervals = np.diff(fine)
    locations = 0.5 * (fine[:-1] + fine[1:]) / fs
    return locations, fs / np.maximum(intervals, EPS)


def _four_tracks(filtered: np.ndarray, fs: float):
    """(negative-going, positive-going, peak, dip) event tracks.

    The sign masks are shared between the +/- variants of each signal (one
    `> 0` pass each for s and its first difference instead of eight
    comparison passes over the full-rate signal)."""
    d = np.diff(filtered)
    pos, neg = filtered > 0.0, filtered < 0.0  # (-s > 0) == (s < 0): keep
    dpos, dneg = d > 0.0, d < 0.0              # exact ==0.0 semantics
    neg_going = np.where(pos[:-1] & ~pos[1:])[0]
    pos_going = np.where(neg[:-1] & ~neg[1:])[0]
    peaks = np.where(dpos[:-1] & ~dpos[1:])[0]
    dips = np.where(dneg[:-1] & ~dneg[1:])[0]
    return [
        _crossing_events(filtered, neg_going, fs),
        _crossing_events(-filtered, pos_going, fs),
        _crossing_events(d, peaks, fs),
        _crossing_events(-d, dips, fs),
    ]


def _interp1(x: np.ndarray, y: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Linear interpolation with linear extrapolation at the edges
    (WORLD's interp1 over event locations)."""
    return np.interp(xq, x, y)


def dio(x_length: int, fs: float, y: np.ndarray, fs_y: float, f0_floor: float = 71.0,
        f0_ceil: float = 800.0, channels_in_octave: float = 2.0, frame_period: float = 5.0,
        allowed_range: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """WORLD DIO with the band analysis on ``y``, the signal decimated to
    ``fs_y``. The frame grid follows the original length ``x_length`` at
    ``fs``. Returns (temporal_positions [s], f0 [Hz], 0 = unvoiced)."""
    n_bands = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundaries = f0_floor * 2.0 ** (np.arange(1, n_bands + 1) / channels_in_octave)
    n_frames = int(x_length / fs * 1000.0 / frame_period) + 1
    temporal_positions = np.arange(n_frames) * frame_period / 1000.0

    candidates = np.zeros((n_bands, n_frames))
    scores = np.full((n_bands, n_frames), MAX_SCORE)
    bands = band_filtered_signals(np.asarray(y, np.float64), boundaries, fs_y)
    for b, boundary in enumerate(boundaries):
        candidates[b], scores[b] = native.world_band_candidates(
            bands[b], fs_y, boundary, f0_floor, f0_ceil, temporal_positions)

    # best candidate per frame: smallest relative deviation
    best_band = np.argmin(scores / (candidates + EPS), axis=0)
    frames = np.arange(n_frames)
    best = np.where(scores[best_band, frames] >= MAX_SCORE, 0.0, candidates[best_band, frames])
    return temporal_positions, native.world_fix_steps(best, candidates, frame_period, f0_floor,
                                                      allowed_range)


def _get_mean_f0_grouped(
    x: np.ndarray, fs: float, positions: np.ndarray, f0s: np.ndarray,
    scores: np.ndarray | None = None,
) -> np.ndarray:
    """GetMeanF0 for many frames at once.

    Frames are grouped by their fft_size (a handful of values); inside a
    group the per-frame Blackman windows (length 2*h_i+1 varies with f0)
    are built by broadcasting and zero-padded into the common fft_size, so
    each group is TWO batched FFTs. The FFT of a zero-padded windowed
    segment equals the per-frame transform — numerically identical to the
    frame-by-frame algorithm."""
    out = np.zeros_like(f0s)
    halves = (1.5 * fs / f0s + 1.0).astype(np.int64)
    wlens = 2 * halves + 1
    fft_sizes = 1 << (
        2 + np.ceil(np.log2(wlens.astype(np.float64))).astype(np.int64)
    )
    x_len = len(x)
    for fft_size in np.unique(fft_sizes):
        sel = np.where(fft_sizes == fft_size)[0]
        h = halves[sel]  # [n]
        wl = wlens[sel]
        max_wl = int(wl.max())
        m = np.arange(max_wl)  # [max_wl]
        valid = m[None, :] < wl[:, None]  # [n, max_wl]

        # sample index: round((pos + (m - h)/fs)*fs + 0.001)
        #             = round(pos*fs + 0.001) + m - h   (integer offset)
        base_idx = np.round(positions[sel] * fs + 0.001).astype(np.int64)
        idx = base_idx[:, None] + m[None, :] - h[:, None]
        idx = np.clip(idx, 0, x_len - 1)
        segments = np.where(valid, x[idx], 0.0)

        # Blackman over the window: position = (m + 0.5) / wlen
        pos = (m[None, :] + 0.5) / wl[:, None]
        main_window = np.where(
            valid,
            0.42 - 0.5 * np.cos(2 * np.pi * pos) + 0.08 * np.cos(4 * np.pi * pos),
            0.0,
        )
        # centered difference with the per-frame boundary handling
        diff_window = np.zeros_like(main_window)
        diff_window[:, 1:-1] = -(main_window[:, 2:] - main_window[:, :-2]) / 2.0
        diff_window[:, 0] = -main_window[:, 1] / 2.0
        rows = np.arange(len(sel))
        last = wl - 1
        diff_window[rows, last] = main_window[rows, last - 1] / 2.0
        # interior formula wrote values past each frame's window — clear them
        diff_window = np.where(valid, diff_window, 0.0)
        # re-apply the boundary value (np.where above kept it: last < wl)

        main_spec = sfft.rfft(segments * main_window, int(fft_size), axis=1, workers=-1)
        diff_spec = sfft.rfft(segments * diff_window, int(fft_size), axis=1, workers=-1)
        power = main_spec.real**2 + main_spec.imag**2 + EPS
        bins = np.arange(main_spec.shape[1], dtype=np.float64)
        inst_freq = bins[None, :] * fs / fft_size + (
            main_spec.real * diff_spec.imag - main_spec.imag * diff_spec.real
        ) / power * fs / (2.0 * np.pi)

        f = f0s[sel]
        ks = np.arange(1, 7, dtype=np.float64)  # up to 6 harmonics
        n_harm = np.minimum((fs / 2.0 / f).astype(np.int64), 6)
        j = np.round(f[:, None] * ks[None, :] * fft_size / fs).astype(np.int64)
        j = np.clip(j, 0, main_spec.shape[1] - 1)
        amp = np.sqrt(power[rows[:, None], j])
        freq = inst_freq[rows[:, None], j]
        valid_k = ks[None, :] <= n_harm[:, None]
        num = np.sum(np.where(valid_k, freq * amp, 0.0), axis=1)
        den = np.sum(np.where(valid_k, amp * ks[None, :], 0.0), axis=1)
        refined = np.where(n_harm >= 1, num / (den + EPS), 0.0)
        out[sel] = refined
        if scores is not None:
            # reliability = fundamental-strength-weighted inverse of the
            # mean amp-weighted relative IF deviation (see native refine_one:
            # the amp(k=1)/max(amp) factor kills subharmonic explanations)
            dev_k = np.abs(freq / ks[None, :] - refined[:, None]) / (
                refined[:, None] + EPS
            )
            dev = np.sum(np.where(valid_k, amp * dev_k, 0.0), axis=1) / (
                np.sum(np.where(valid_k, amp, 0.0), axis=1) + EPS
            )
            amax = np.max(np.where(valid_k, amp, 0.0), axis=1)
            w1 = amp[:, 0] / (amax + EPS)
            scores[sel] = np.where(n_harm >= 1, w1 / (dev + EPS), 0.0)
    return out

"""Faithful port of Praat's ``Sound: To Pitch (ac)`` (Boersma 1993).

A copy of ``sovits_tpu/f0/praat.py`` (numpy only), kept in the port so that
it imports nothing of the JAX package; the two are held equal by
``tests/test_torch_train.py::test_pm_matches_jax``.

The reference's ``pm`` predictor wraps parselmouth
(modules/F0Predictor/PMF0Predictor.py:33-47: ``to_pitch_ac`` with
time_step=hop/sr, voicing_threshold=0.6, pitch_floor=f0_min,
pitch_ceiling=f0_max) and takes ``selected_array['frequency']``. This module
ports the published algorithm (Boersma, "Accurate short-term analysis of
the fundamental frequency and the harmonics-to-noise ratio of a sampled
sound", IFA Proceedings 17, 1993) together with Praat's documented
implementation behavior, written independently (no Praat code vendored):

- Praat's frame grid: windowDuration = 3 / pitch_floor, frame count
  floor((duration - windowDuration)/dt) + 1, times centered on the signal
  midpoint — so the frame count and the reference's symmetric pad to p_len
  line up exactly.
- Praat's Hanning window w[j] = 0.5 - 0.5 cos(2pi (j+1)/(N+1)) (NOT
  numpy.hanning), even length N = 2*(floor(windowDuration*fs)/2 - 1).
- local mean subtraction over the window, then windowing (paper section 2).
- FFT autocorrelation at size 2^ceil >= N*(1+interpolation_depth) with
  interpolation_depth = 0.5 (the paper's "append half a window of zeroes"),
  normalized by lag 0 AND by the window's own normalized autocorrelation
  (paper eq. 9: r_x(tau) ~= r_xw(tau) / r_w(tau)).
- candidate peaks gated on r > 0.5*voicing_threshold, refined by
  tapered-sinc interpolation of r (Praat improves each maximum through
  sinc-interpolated optimization; here a 24-point offset grid over a
  70-sample raised-cosine-tapered sinc kernel plus a parabolic refine —
  lag precision ~1e-3 samples, far below the tracker's own error).
- strength R clipped by R > 1 -> 1/R (Praat's "reflect above 1").
- candidate list keeps the strongest max_candidates-1 voiced candidates
  ranked by R - octave_cost*log2(pitch_floor/f) (the paper's selection
  weight, eq. 24).
- Viterbi path finder with Praat's cost semantics: costs scaled by
  timeStepCorrection = dt/0.01, unvoiced local strength
  voicing_threshold + max(0, 2 - intensity/(silence_threshold/(1+voicing_
  threshold))) (eq. 23), voiced local strength R - octave_cost *
  log2(pitch_ceiling/f) (the path finder re-weights against the CEILING,
  not the floor), transition costs 0 / voiced_unvoiced_cost /
  octave_jump_cost*|log2(f1/f2)| (eqs. 25-27).

Known residual deviations from parselmouth (not installable in this
environment, so unpinned): half-sample placement of the analysis window
(Praat's xToLowIndex rounding), localPeak taken over the middle half of
the windowed frame, and the exact shape of Praat's sinc taper. Each is
sub-candidate-resolution; accuracy on the speechlike fixtures is pinned by
tests/test_f0.py (median error < 3 Hz, voicing agreement) and the derived
candidate/path vectors by tests/test_praat_vectors.py.
"""

from __future__ import annotations

import numpy as np

from .base import F0Predictor

_SINC_HALF = 35  # 70-sample interpolation window (Praat's sinc70)
_OFFSET_GRID = 24


def _praat_window(n: int) -> np.ndarray:
    """Praat's Hanning: w[j] = 0.5 - 0.5 cos(2 pi (j+1) / (n+1))."""
    j = np.arange(1, n + 1, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * j / (n + 1))


def _tapered_sinc_weights(offsets: np.ndarray) -> np.ndarray:
    """W[g, k]: value at r[lag + k - HALF] of a raised-cosine-tapered sinc
    evaluated at offset delta_g. Rows reproduce an interpolated r(lag +
    delta_g) as a dot product with the 70 neighbouring samples."""
    k = np.arange(-_SINC_HALF, _SINC_HALF + 1, dtype=np.float64)[None, :]
    x = offsets[:, None] - k
    w = np.sinc(x)  # sin(pi x)/(pi x)
    taper = 0.5 + 0.5 * np.cos(np.pi * x / (_SINC_HALF + 1))
    return w * np.where(np.abs(x) <= _SINC_HALF + 1, taper, 0.0)


def to_pitch_ac(
    x: np.ndarray,
    fs: float,
    time_step: float,
    voicing_threshold: float = 0.45,
    pitch_floor: float = 75.0,
    pitch_ceiling: float = 600.0,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    max_candidates: int = 15,
    periods_per_window: float = 3.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Praat ``To Pitch (ac)``: returns (frame_times [s], f0 [Hz], 0=unvoiced).

    Defaults are Praat's; the reference passes voicing_threshold=0.6 and its
    own floor/ceiling/time_step (PMF0Predictor.py:44-46).
    """
    x = np.asarray(x, np.float64)
    duration = len(x) / fs
    global_mean = x.mean()
    xz = x - global_mean
    global_peak = np.max(np.abs(xz)) + 1e-30

    dt_window = periods_per_window / pitch_floor
    nsamp_window = int(np.floor(dt_window * fs))
    half_window = nsamp_window // 2 - 1
    if half_window < 2:
        raise ValueError("pitch_floor too high for the sampling rate")
    nsamp_window = half_window * 2
    window = _praat_window(nsamp_window)

    # frame grid (Sampled_shortTermAnalysis): centered on the midpoint
    n_frames = int(np.floor((duration - dt_window) / time_step)) + 1
    n_frames = max(n_frames, 1)
    t1 = 0.5 * duration - 0.5 * (n_frames - 1) * time_step
    times = t1 + np.arange(n_frames) * time_step

    maximum_lag = int(np.floor(nsamp_window / periods_per_window)) + 2
    lag_min = max(int(np.floor(fs / pitch_ceiling)), 2)
    # candidates only where the sinc interpolation stays inside the window
    brent_ixmax = int(nsamp_window * 0.5)
    lag_max = min(maximum_lag, brent_ixmax)

    nfft = 1
    while nfft < nsamp_window * 1.5:
        nfft *= 2

    # window's own normalized autocorrelation (shared by all frames)
    wf = np.fft.rfft(window, nfft)
    r_w = np.fft.irfft(wf.real**2 + wf.imag**2)[: lag_max + _SINC_HALF + 2]
    r_w = r_w / r_w[0]

    # ---- all frames at once: extract, de-mean, window, autocorrelate ----
    starts = np.round(times * fs).astype(np.int64) - half_window
    idx = starts[:, None] + np.arange(nsamp_window)[None, :]
    valid = (idx >= 0) & (idx < len(xz))
    frames = np.where(valid, xz[np.clip(idx, 0, len(xz) - 1)], 0.0)
    n_valid = np.maximum(valid.sum(axis=1), 1)
    local_mean = frames.sum(axis=1) / n_valid
    frames = np.where(valid, frames - local_mean[:, None], 0.0) * window[None, :]

    # localPeak over the middle half of the windowed frame (Praat takes the
    # peak around the window center); intensity caps at 1
    mid = frames[:, half_window // 2 : half_window // 2 + nsamp_window // 2 + 1]
    local_peak = np.max(np.abs(mid), axis=1)
    intensity = np.minimum(local_peak / global_peak, 1.0)

    f = np.fft.rfft(frames, nfft, axis=1)
    r = np.fft.irfft(f.real**2 + f.imag**2, axis=1)[:, : lag_max + _SINC_HALF + 2]
    r0 = r[:, :1].copy()
    r = np.where(r0 > 0, r / np.maximum(r0, 1e-300), 0.0)
    r = r / np.maximum(r_w[None, :], 1e-12)

    # ---- candidate generation ----
    n_cand = max_candidates
    cand_f0 = np.zeros((n_frames, n_cand))
    cand_r = np.zeros((n_frames, n_cand))  # stored strength R
    offsets = np.linspace(-1.0, 1.0, _OFFSET_GRID)
    w_sinc = _tapered_sinc_weights(offsets)  # [G, 71]
    gate = 0.5 * voicing_threshold

    for i in range(n_frames):
        ri = r[i]
        seg = ri[lag_min : lag_max]
        peaks = (
            np.flatnonzero(
                (seg > gate)
                & (seg > ri[lag_min - 1 : lag_max - 1])
                & (seg >= ri[lag_min + 1 : lag_max + 1])
            )
            + lag_min
        )
        if len(peaks) == 0:
            cand_r[i, 0] = 1.0  # marker; strength set in the path finder
            continue
        # sinc-refine each integer peak on a +-1-lag offset grid
        kwin = peaks[:, None] + np.arange(-_SINC_HALF, _SINC_HALF + 1)[None, :]
        rwin = np.where(
            (kwin >= 0) & (kwin < len(ri)), ri[np.clip(kwin, 0, len(ri) - 1)], 0.0
        )
        vals = rwin @ w_sinc.T  # [P, G]
        g_best = np.argmax(vals, axis=1)
        g_in = np.clip(g_best, 1, _OFFSET_GRID - 2)
        vm1 = vals[np.arange(len(peaks)), g_in - 1]
        v0 = vals[np.arange(len(peaks)), g_in]
        vp1 = vals[np.arange(len(peaks)), g_in + 1]
        denom = vm1 - 2 * v0 + vp1
        delta = np.where(
            np.abs(denom) > 1e-30, 0.5 * (vm1 - vp1) / denom, 0.0
        )
        step = offsets[1] - offsets[0]
        lag_ref = peaks + offsets[g_in] + np.clip(delta, -1, 1) * step
        strength = v0 + 0.5 * np.clip(delta, -1, 1) * (vp1 - vm1) * 0.5
        strength = np.where(strength > 1.0, 1.0 / strength, strength)
        freq = fs / lag_ref

        # keep the strongest (selection weight, paper eq. 24)
        weight = strength - octave_cost * np.log2(pitch_floor * lag_ref / fs)
        order = np.argsort(weight)[::-1][: n_cand - 1]
        kept = order[freq[order] > 0]
        cand_f0[i, 1 : 1 + len(kept)] = freq[kept]
        cand_r[i, 1 : 1 + len(kept)] = strength[kept]

    # ---- Viterbi path finder (Pitch_pathFinder semantics) ----
    correction = time_step / 0.01
    jump_cost = octave_jump_cost * correction
    vuv_cost = voiced_unvoiced_cost * correction

    unvoiced_strength = voicing_threshold + np.maximum(
        0.0, 2.0 - intensity / (silence_threshold / (1.0 + voicing_threshold))
    )
    voiceless = (cand_f0 <= 0.0) | (cand_f0 >= pitch_ceiling)
    local = np.where(
        voiceless,
        unvoiced_strength[:, None],
        cand_r - octave_cost * np.log2(pitch_ceiling / np.maximum(cand_f0, 1e-12)),
    )

    psi = local[0].copy()
    back = np.zeros((n_frames, n_cand), dtype=np.int32)
    for t in range(1, n_frames):
        f_prev = cand_f0[t - 1][:, None]
        f_cur = cand_f0[t][None, :]
        uv_prev = voiceless[t - 1][:, None]
        uv_cur = voiceless[t][None, :]
        trans = np.where(
            uv_prev & uv_cur,
            0.0,
            np.where(
                uv_prev != uv_cur,
                vuv_cost,
                jump_cost
                * np.abs(
                    np.log2(np.maximum(f_prev, 1e-12) / np.maximum(f_cur, 1e-12))
                ),
            ),
        )
        total = psi[:, None] - trans + local[t][None, :]
        back[t] = np.argmax(total, axis=0)
        psi = total[back[t], np.arange(n_cand)]

    path = np.zeros(n_frames, dtype=np.int32)
    path[-1] = int(np.argmax(psi))
    for t in range(n_frames - 2, -1, -1):
        path[t] = back[t + 1][path[t + 1]]
    f0 = cand_f0[np.arange(n_frames), path]
    f0 = np.where(voiceless[np.arange(n_frames), path], 0.0, f0)
    return times, f0


class ParselmouthF0Predictor(F0Predictor):
    """``pm``: Praat To Pitch (ac) port (PMF0Predictor.py:17-74 contract).

    Frame-count/padding contract matches the reference exactly: Praat emits
    floor((duration - 3/f0_min)/dt) + 1 centered frames and the reference
    pads symmetrically to p_len (PMF0Predictor.py:48-51); ``raw_f0``
    reproduces both."""

    name = "pm"

    voicing_threshold = 0.6
    silence_threshold = 0.03
    octave_cost = 0.01
    octave_jump_cost = 0.35
    voiced_unvoiced_cost = 0.14
    max_candidates = 15

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        fs = float(self.sampling_rate)
        time_step = self.hop_length / fs
        _times, f0 = to_pitch_ac(
            np.asarray(wav, np.float64),
            fs,
            time_step=time_step,
            voicing_threshold=self.voicing_threshold,
            pitch_floor=self.f0_min,
            pitch_ceiling=self.f0_max,
            silence_threshold=self.silence_threshold,
            octave_cost=self.octave_cost,
            octave_jump_cost=self.octave_jump_cost,
            voiced_unvoiced_cost=self.voiced_unvoiced_cost,
            max_candidates=self.max_candidates,
        )
        pad = (p_len - len(f0) + 1) // 2
        if pad > 0 or p_len - len(f0) - pad > 0:
            f0 = np.pad(f0, (max(pad, 0), max(p_len - len(f0) - pad, 0)))
        return f0[:p_len]

"""Port of WORLD's Harvest F0 estimator (Morise, INTERSPEECH 2017); the
counterpart of ``sovits_tpu/f0/world_harvest.py``, a numpy copy whose
loop-heavy stages 3, 6 and 7 run in the port's native library by default.

The reference delegates to ``pyworld.harvest``
(modules/F0Predictor/HarvestF0Predictor.py:46-69). This module ports the
published algorithm following harvest.cpp's stage structure, written
independently (no WORLD source is vendored):

1.  decimate the signal to ~8 kHz (MATLAB-style Chebyshev-I + filtfilt),
2.  band-pass around a DENSE boundary-f0 grid (40 channels/octave,
    Nuttall-windowed cosine carriers, two periods long),
3.  per channel, estimate a raw candidate per 1 ms frame from the four
    event-interval tracks (negative/positive zero crossings, peaks, dips);
    accept only where the mean lies within +-10% of the channel boundary,
4.  collapse vertically-connected channel runs into official candidates,
5.  overlap candidates across +-3 neighbour frames,
6.  refine every candidate on the decimated signal by harmonic
    instantaneous frequency and score it by harmonic reliability,
7.  drop candidates with no close (5%) neighbour in the adjacent frames,
8.  track the best-scored contour, remove jumps (0.8% frame-to-frame) and
    short voiced islands, extend sections with agreeing (18%) candidates,
9.  zero-phase biquad smoothing of each voiced section,
10. resample the 1 ms contour to the requested frame_period.

Exact per-stage thresholds follow the published description where given;
the remaining constants are marked inline. Bit-parity with pyworld is NOT
claimed (no pyworld goldens are recorded); the JAX package validates its
accuracy on synthetic-speech fixtures (tests/test_f0.py), and the port's
tests hold this copy to it. ``use_native=False`` runs every stage in
float64 numpy: the JAX package's oracle path, and the oracle of the native
entry points.
"""

from __future__ import annotations

import numpy as np
from scipy import fft as sfft
from scipy import signal as sps

from .. import native
from .world_dio import (
    EPS,
    _four_tracks,
    _get_mean_f0_grouped,
    _interp1,
    _suitable_fft_size,
    decimate,
    nuttall_window,
)

CHANNELS_IN_OCTAVE = 40.0
BASIC_FRAME_PERIOD_MS = 1.0
TARGET_FS = 8000.0
MAX_CANDIDATE_OVERLAP = 3  # +-frames a candidate is copied to
UNRELIABLE_THRESHOLD = 0.05  # neighbour-agreement gate after refinement
TRACK_AGREEMENT = 0.1  # max relative deviation of the four event tracks
JUMP_ALLOWED_RANGE = 0.008  # FixStep1 frame-to-frame relative jump
EXTEND_ALLOWED_RANGE = 0.18  # section extension candidate agreement
VOICE_RANGE_MINIMUM = 9  # minimum voiced-section length (1 ms frames)
SCORE_MINIMUM = 2.5  # refinement reliability gate
# _remove_unreliable flattened-searchsorted constants: empty candidate
# slots sort above every real f0 (< f0_ceil ~1.1e3) but below the per-row
# lift so rows never interleave
_EMPTY_SENTINEL = 1e5
_ROW_LIFT = 1e6
# 2nd-order zero-phase lowpass used by WORLD's SmoothF0Contour
SMOOTH_B = (0.0078202080334971724, 0.015640416066994345, 0.0078202080334971724)
SMOOTH_A = (1.7347257688092754, -0.76600660094326412)


def _band_half_width(actual_fs: float, boundary_f0: float) -> int:
    return int(round(actual_fs / boundary_f0 * 2.0))  # two periods


def _band_candidate_from_filtered(
    filtered: np.ndarray, actual_fs: float, boundary_f0: float,
    f0_floor: float, f0_ceil: float, temporal_positions: np.ndarray,
) -> np.ndarray:
    """Raw candidate contour for one boundary channel (stage 3), numpy
    oracle for native world_harvest_band_candidates."""
    tracks = _four_tracks(filtered, actual_fs)
    if not all(len(loc) > 2 for loc, _ in tracks):
        return np.zeros(len(temporal_positions))
    interpolated = np.stack(
        [_interp1(loc, f0v, temporal_positions) for loc, f0v in tracks]
    )
    candidate = interpolated.mean(axis=0)
    # "an F0 candidate is estimated ... if the four estimates are almost
    # the same" (Morise 2017 §2.2): gate on track agreement — inharmonic
    # (noise) sections make the four event intervals disagree
    deviation = np.abs(interpolated - candidate).max(axis=0)
    bad = (
        (candidate > boundary_f0 * 1.1)
        | (candidate < boundary_f0 * 0.9)
        | (candidate > f0_ceil)
        | (candidate < f0_floor)
        | (deviation > candidate * TRACK_AGREEMENT)
    )
    return np.where(bad, 0.0, candidate)


def _detect_official_candidates(raw: np.ndarray, max_candidates: int) -> np.ndarray:
    """Collapse vertical runs of agreeing channels into official candidates.

    raw: [n_channels, n_frames] -> [n_frames, max_candidates]. A run of >=2
    consecutive channels with nonzero candidates yields one candidate (the
    run mean) — a single isolated channel is treated as noise."""
    n_ch, n_frames = raw.shape
    # flatten frame-major with a guard channel of zeros so no run spans two
    # frames; vertical runs become maximal 1-D runs of the flat mask
    g = np.concatenate([raw.T, np.zeros((n_frames, 1))], axis=1).reshape(-1)
    nz = g > 0.0
    d = np.diff(nz.astype(np.int8), prepend=np.int8(0))
    starts = np.where(d == 1)[0]
    ends = np.where(d == -1)[0]  # g[end] == 0, run = [start, end)
    lens = ends - starts
    keep = lens >= 2  # a single isolated channel is treated as noise
    starts, ends, lens = starts[keep], ends[keep], lens[keep]
    csum = np.concatenate([[0.0], np.cumsum(g)])
    means = (csum[ends] - csum[starts]) / lens
    frames = starts // (n_ch + 1)
    # occurrence rank within each frame (starts ascend, so order matches
    # the bottom-up channel scan)
    first = np.searchsorted(frames, np.arange(n_frames), side="left")
    ranks = np.arange(len(frames)) - first[frames]
    ok = ranks < max_candidates
    out = np.zeros((n_frames, max_candidates))
    out[frames[ok], ranks[ok]] = means[ok]
    return out


def _overlap_candidates(cands: np.ndarray, max_count: int) -> np.ndarray:
    """Copy each frame's candidates to +-1..max_count neighbour frames."""
    n_frames, k = cands.shape
    out = np.zeros((n_frames, k * (2 * max_count + 1)))
    out[:, :k] = cands
    col = k
    for off in range(1, max_count + 1):
        out[off:, col : col + k] = cands[:-off]
        col += k
        out[:-off, col : col + k] = cands[off:]
        col += k
    return out


def _refine_candidates(
    x: np.ndarray, fs: float, temporal_positions: np.ndarray,
    cands: np.ndarray, f0_floor: float, f0_ceil: float,
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Stage 6: instantaneous-frequency refinement + reliability scores."""
    n_frames, k = cands.shape
    flat = cands.reshape(-1)
    pos = np.repeat(temporal_positions, k)
    sel = np.where(flat > 0.0)[0]
    refined = np.zeros_like(flat)
    scores = np.zeros_like(flat)
    if len(sel):
        if use_native:
            r, s = native.world_refine_f0(x, fs, pos[sel], flat[sel])
        else:
            s = np.zeros(len(sel))
            r = _get_mean_f0_grouped(x, fs, pos[sel], flat[sel], scores=s)
        bad = (r < f0_floor) | (r > f0_ceil) | (s < SCORE_MINIMUM)
        refined[sel] = np.where(bad, 0.0, r)
        scores[sel] = np.where(bad, 0.0, s)
    return refined.reshape(n_frames, k), scores.reshape(n_frames, k)


def _remove_unreliable(cands: np.ndarray, scores: np.ndarray) -> None:
    """Stage 7 (in place): a candidate survives only if each EXISTING
    neighbour frame holds some candidate within 5% of it. Agreement is
    checked against a snapshot of the candidate matrix — removals must not
    cascade along the time axis."""
    n_frames, k = cands.shape
    frozen = cands.copy()
    live = frozen > 0.0
    ok = live.copy()
    sorted_rows = np.sort(np.where(live, frozen, _EMPTY_SENTINEL), axis=1)
    for dt in (-1, 1):
        # neigh[t] = frozen[t + dt]; frames whose neighbour is out of range
        # carry no constraint from this direction
        if dt == -1:
            tt = slice(1, n_frames)
            rows = sorted_rows[:-1]
        else:
            tt = slice(0, n_frames - 1)
            rows = sorted_rows[1:]
        cur = frozen[tt]
        # nearest live neighbour-candidate per current candidate via one
        # global searchsorted: each sorted neighbour row is lifted by a
        # per-row offset far above any f0, making the flattened array
        # monotone; empty slots carry a sentinel below the offset step
        # so an empty neighbour frame yields a huge deviation (kills the
        # whole frame, as WORLD does). The lift is kept small (1e6, vs
        # f0 < f0_ceil ~1.1e3 and the 1e5 sentinel) so that even for
        # hour-scale inputs (rows ~1e6 -> offsets ~1e12) float64 retains
        # ~1e-4 Hz resolution and the 5% agreement gate never quantizes.
        lift = _ROW_LIFT
        n = cur.shape[0]
        offs = np.arange(n) * lift
        flat = (rows + offs[:, None]).reshape(-1)
        q = cur + offs[:, None]
        hi = np.searchsorted(flat, q.reshape(-1)).reshape(n, k)
        lo = hi - 1
        row0 = np.arange(n)[:, None] * k
        hi_v = flat[np.minimum(hi, row0 + k - 1)]
        lo_v = flat[np.maximum(lo, row0)]
        near = np.minimum(np.abs(hi_v - q), np.abs(q - lo_v))
        merr = near / (cur + EPS)
        ok[tt] &= merr <= UNRELIABLE_THRESHOLD
    kill = live & ~ok
    cands[kill] = 0.0
    scores[kill] = 0.0


def _voiced_sections(f0: np.ndarray) -> list[tuple[int, int]]:
    """[start, end) spans of consecutive voiced frames."""
    v = f0 > 0.0
    edges = np.diff(v.astype(np.int8))
    starts = list(np.where(edges == 1)[0] + 1)
    ends = list(np.where(edges == -1)[0] + 1)
    if v[0]:
        starts.insert(0, 0)
    if v[-1]:
        ends.append(len(f0))
    return list(zip(starts, ends))


def _fix_contour(cands: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Stage 8: best-score base contour, jump removal, short-section
    removal, section extension with agreeing candidates."""
    n_frames, _k = cands.shape
    best = np.argmax(scores, axis=1)
    rows = np.arange(n_frames)
    f0 = np.where(scores[rows, best] > 0.0, cands[rows, best], 0.0)

    # FixStep1: frame-to-frame jumps
    prev = np.concatenate([[0.0], f0[:-1]])
    jump = np.abs(f0 - prev) / (f0 + EPS) > JUMP_ALLOWED_RANGE
    f0 = np.where(jump, 0.0, f0)

    # FixStep2: drop voiced islands shorter than VOICE_RANGE_MINIMUM
    for s, e in _voiced_sections(f0):
        if e - s < VOICE_RANGE_MINIMUM:
            f0[s:e] = 0.0

    # FixStep3/4: extend sections with agreeing candidates and MERGE — an
    # extension is kept only where it bridges to the neighbouring section
    # (its role is repairing dropouts inside a voiced region); dangling
    # extensions into silence are discarded.
    sections = _voiced_sections(f0)
    out = f0.copy()
    for i, (s, e) in enumerate(sections):
        nxt = sections[i + 1][0] if i + 1 < len(sections) else None
        if nxt is None:
            break
        # forward pass from this section's tail
        fwd = np.zeros(nxt - e)
        ref = out[e - 1]
        reach = 0
        for j in range(e, nxt):
            c = cands[j][cands[j] > 0.0]
            if len(c) == 0:
                break
            errs = np.abs(c - ref) / (ref + EPS)
            b_i = int(np.argmin(errs))
            if errs[b_i] >= EXTEND_ALLOWED_RANGE:
                break
            fwd[j - e] = ref = c[b_i]
            reach = j - e + 1
        if reach == nxt - e:  # bridged the whole gap
            out[e:nxt] = fwd
            continue
        # backward pass from the next section's head
        bwd = np.zeros(nxt - e)
        ref = f0[nxt]
        back = nxt
        for j in range(nxt - 1, e - 1, -1):
            c = cands[j][cands[j] > 0.0]
            if len(c) == 0:
                break
            errs = np.abs(c - ref) / (ref + EPS)
            b_i = int(np.argmin(errs))
            if errs[b_i] >= EXTEND_ALLOWED_RANGE:
                break
            bwd[j - e] = ref = c[b_i]
            back = j
        if back - e <= reach:  # forward and backward meet: bridge the gap
            meet = e + reach
            out[e:meet] = fwd[:reach]
            out[meet:nxt] = bwd[meet - e :]
    return out


def _smooth_contour(f0: np.ndarray) -> np.ndarray:
    """Stage 9: zero-phase biquad over each voiced section, 300-frame
    padding at the edges as WORLD's SmoothF0Contour (edge-value padding
    rather than zeros, so section boundaries settle instead of ramping)."""
    out = np.zeros_like(f0)
    b = np.asarray(SMOOTH_B)
    a = np.asarray([1.0, -SMOOTH_A[0], -SMOOTH_A[1]])
    for s, e in _voiced_sections(f0):
        seg = np.concatenate(
            [np.full(300, f0[s]), f0[s:e], np.full(300, f0[e - 1])]
        )
        fwd = sps.lfilter(b, a, seg)
        sm = sps.lfilter(b, a, fwd[::-1])[::-1]
        out[s:e] = sm[300 : 300 + (e - s)]
    return out


def harvest(
    x: np.ndarray,
    fs: float,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    frame_period: float = 5.0,  # ms
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """WORLD Harvest. Returns (temporal_positions [s], f0 [Hz], 0=unvoiced)."""
    x = np.asarray(x, np.float64)
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    n_channels = 1 + int(np.log2(adj_ceil / adj_floor) * CHANNELS_IN_OCTAVE)
    boundaries = adj_floor * 2.0 ** (np.arange(1, n_channels + 1) / CHANNELS_IN_OCTAVE)

    ratio = int(np.clip(fs / TARGET_FS, 1, 12))
    y = decimate(x, ratio)
    actual_fs = fs / ratio
    y = y - y.mean()
    y_length = len(y)

    n_basic = int(len(x) / fs * 1000.0 / BASIC_FRAME_PERIOD_MS) + 1
    basic_positions = np.arange(n_basic) * BASIC_FRAME_PERIOD_MS / 1000.0

    min_fft = y_length + 1 + 2 * (_band_half_width(actual_fs, boundaries[0]) * 2 + 1)
    if use_native:
        # pocketfft handles 5-smooth sizes as fast as pow2; WORLD's pow2
        # round-up (81k -> 131k for a 10 s clip) costs ~1.6x extra filter
        # work. Any size >= the linear-convolution length is mathematically
        # identical; the numpy oracle keeps WORLD's pow2 so its derivation
        # stays bit-comparable with the published algorithm.
        fft_size = sfft.next_fast_len(min_fft, real=True)
    else:
        fft_size = _suitable_fft_size(min_fft)

    # the fast path filters in float32 (~1e-6-relative rounding, same
    # trade as DIO's fast mode — estimation error dominates); the numpy
    # oracle keeps float64
    filter_dtype = np.float32 if use_native else np.float64
    y_spec = sfft.rfft(y.astype(filter_dtype), fft_size, workers=-1)

    # stage 2 batched: FIR spectra, filtering, and inverse transforms run
    # as 2-D pocketfft calls over channel chunks (one r2c/c2r each instead
    # of one per channel); stage 3 extracts candidates per channel (C++
    # fast path, numpy oracle otherwise)
    raw = np.zeros((n_channels, n_basic))
    chunk = 16
    grid = np.arange(fft_size)
    for s in range(0, n_channels, chunk):
        bnd = boundaries[s : s + chunk]
        firs = np.zeros((len(bnd), fft_size), filter_dtype)
        for j, boundary in enumerate(bnd):
            half = _band_half_width(actual_fs, boundary)
            n = half * 2 + 1
            firs[j, :n] = nuttall_window(n) * np.cos(
                2 * np.pi * boundary * grid[:n] / actual_fs
            )
        filt = sfft.irfft(
            sfft.rfft(firs, axis=1, workers=-1) * y_spec[None, :],
            fft_size, axis=1, workers=-1,
        )
        halves = np.asarray(
            [_band_half_width(actual_fs, b) for b in bnd], np.int64
        )
        if use_native:
            # whole chunk in one ctypes crossing, f32 consumed in place
            raw[s : s + len(bnd)] = native.world_harvest_band_candidates_multi(
                filt, halves, y_length, actual_fs, bnd, adj_floor, adj_ceil,
                TRACK_AGREEMENT, basic_positions,
            )
            continue
        for j, boundary in enumerate(bnd):
            half = int(halves[j])
            raw[s + j] = _band_candidate_from_filtered(
                filt[j, half : half + y_length], actual_fs, boundary, adj_floor,
                adj_ceil, basic_positions,
            )

    max_candidates = max(1, int(round(n_channels / 10.0)))
    cands = _detect_official_candidates(raw, max_candidates)
    cands = _overlap_candidates(cands, MAX_CANDIDATE_OVERLAP)
    # refinement runs on the DECIMATED signal, as harvest.cpp's
    # RefineF0Candidates does (its y/actual_fs come from
    # GetWaveformAndSpectrum) — the ~8 kHz band still covers the six
    # harmonics used for typical voice f0, and the windows are ratio-times
    # shorter than at the original rate
    cands, scores = _refine_candidates(
        y, actual_fs, basic_positions, cands, f0_floor, f0_ceil,
        use_native=use_native,
    )
    if use_native:
        # C++ stage 7: the numpy sentinel-sort formulation is the hottest
        # harvest stage; the native one is held to it bit for bit in the tests
        native.world_harvest_remove_unreliable(
            cands, scores, UNRELIABLE_THRESHOLD
        )
    else:
        _remove_unreliable(cands, scores)
    f0_1ms = _fix_contour(cands, scores)
    f0_1ms = _smooth_contour(f0_1ms)

    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    temporal_positions = np.arange(n_frames) * frame_period / 1000.0
    idx = np.minimum(
        np.round(temporal_positions * 1000.0).astype(np.int64), n_basic - 1
    )
    return temporal_positions, f0_1ms[idx]

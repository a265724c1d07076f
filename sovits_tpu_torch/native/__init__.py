"""The port's native WORLD library (DIO + StoneMask, Harvest), bound with ctypes.

``world_f0.cpp`` is compiled with g++ at first use, through the kernels'
build helpers (``ops/build.py``), into
``build/sovits_tpu_torch/libworld_f0-<hash>.so`` at the repository root,
where ``<hash>`` covers the source and the flags, so an edited source is
rebuilt and an unchanged one reused. The flags carry no ``-march=native``:
a library built on one host must load on another. If it cannot be built,
the functions here raise; there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from ..ops import build

SOURCE = Path(__file__).resolve().parent / "world_f0.cpp"
CXX_FLAGS = ("-O3", "-fopenmp-simd", "-fPIC", "-shared", "-std=c++17")

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_DBL = ctypes.c_double
SIGNATURES = {
    "world_dio_f0_length": ([_I64, _DBL, _DBL], ctypes.c_int),
    "world_dio": ([_D, _I64] + [_DBL] * 6 + [_D, _D], None),
    "world_stonemask": ([_D, _I64, _DBL, _D, _D, _I64, _D], None),
    "world_band_candidates_f": ([_F, _I64] + [_DBL] * 4 + [_D, _I64, _D, _D], None),
    "world_fix_steps": ([_D, _D, _I64, _I64, _DBL, _DBL, _DBL, _D], None),
    "world_fir_decimate_f": ([_F, _I64, _F, _I64, _I64, _F, _I64], None),
    "world_harvest_band_candidates_multi": (
        [_D, _I64, _I64, _I64P, _I64, _DBL, _D] + [_DBL] * 3 + [_D, _I64, _D], None),
    "world_harvest_band_candidates_multi_f": (
        [_F, _I64, _I64, _I64P, _I64, _DBL, _D] + [_DBL] * 3 + [_D, _I64, _D], None),
    "world_harvest_remove_unreliable": ([_D, _D, _I64, _I64, _DBL], None),
    "world_refine_f0": ([_D, _I64, _DBL, _D, _D, _I64, _D, _D], None),
}

_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    return build.library_path(SOURCE, CXX_FLAGS)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = library_path()
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++): cannot build the native WORLD library")
        build.finish_build(build.start_build([cxx, *CXX_FLAGS], SOURCE, out))
    _LIB = build.bind(out, SIGNATURES)
    return _LIB


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_D)


def world_dio(x: np.ndarray, fs: float, frame_period: float = 5.0, f0_floor: float = 71.0,
              f0_ceil: float = 800.0, channels_in_octave: float = 2.0,
              allowed_range: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """Full-rate WORLD DIO. Returns (temporal_positions [s], f0 [Hz])."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    n = lib.world_dio_f0_length(len(x), float(fs), float(frame_period))
    tpos = np.empty(n, np.float64)
    f0 = np.empty(n, np.float64)
    lib.world_dio(_dp(x), len(x), float(fs), float(frame_period), float(f0_floor),
                  float(f0_ceil), float(channels_in_octave), float(allowed_range),
                  _dp(tpos), _dp(f0))
    return tpos, f0


def world_stonemask(x: np.ndarray, fs: float, temporal_positions: np.ndarray,
                    f0: np.ndarray) -> np.ndarray:
    """StoneMask refinement of a DIO contour."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    out = np.empty_like(f0)
    lib.world_stonemask(_dp(x), len(x), float(fs), _dp(tpos), _dp(f0), len(f0), _dp(out))
    return out


def world_band_candidates(filtered: np.ndarray, fs: float, boundary_f0: float,
                          f0_floor: float, f0_ceil: float,
                          temporal_positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Event tracks + interpolation + candidate/score of one float32
    band-filtered signal (the loop-heavy middle of DIO)."""
    lib = load()
    filtered = np.ascontiguousarray(filtered, dtype=np.float32)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    cand = np.empty(len(tpos), np.float64)
    score = np.empty(len(tpos), np.float64)
    lib.world_band_candidates_f(filtered.ctypes.data_as(_F), len(filtered), float(fs),
                                float(boundary_f0), float(f0_floor), float(f0_ceil),
                                _dp(tpos), len(tpos), _dp(cand), _dp(score))
    return cand, score


def world_fix_steps(best: np.ndarray, candidates: np.ndarray, frame_period_ms: float,
                    f0_floor: float, allowed_range: float) -> np.ndarray:
    """DIO's four contour-fixing passes (candidates [n_bands, n_frames])."""
    lib = load()
    best = np.ascontiguousarray(best, dtype=np.float64)
    candidates = np.ascontiguousarray(candidates, dtype=np.float64)
    out = np.empty_like(best)
    lib.world_fix_steps(_dp(best), _dp(candidates), candidates.shape[0], candidates.shape[1],
                        float(frame_period_ms), float(f0_floor), float(allowed_range), _dp(out))
    return out


_FIR_CACHE: dict[int, np.ndarray] = {}


def _decimation_fir(ratio: int) -> np.ndarray:
    """Linear-phase Kaiser lowpass at WORLD's decimate cutoff (0.8 nyq/ratio):
    beta 8, Kaiser-formula length for the 0.2 nyq/ratio transition band,
    rounded odd so the centre tap sits on a sample (zero phase)."""
    h = _FIR_CACHE.get(ratio)
    if h is None:
        from scipy import signal as sps

        width = 0.2 / ratio
        ntaps = int(np.ceil((8.0 / 0.1102 + 7.95) / (14.36 * width / 2.0)))
        ntaps += 1 - ntaps % 2
        h = sps.firwin(ntaps, 0.9 / ratio, window=("kaiser", 8.0))
        _FIR_CACHE[ratio] = h
    return h


def fir_decimate(x: np.ndarray, ratio: int) -> np.ndarray:
    """Zero-phase polyphase FIR decimation in float32: y[m] = (h * x)[m ratio]
    with zero-padded edges, the length of x[::ratio]. Returns float64."""
    if ratio <= 1:
        return np.asarray(x, np.float64).copy()
    lib = load()
    h = np.ascontiguousarray(_decimation_fir(ratio), dtype=np.float32)
    xf = np.ascontiguousarray(x, dtype=np.float32)
    n_out = -(-len(xf) // ratio)
    out = np.empty(n_out, np.float32)
    lib.world_fir_decimate_f(xf.ctypes.data_as(_F), len(xf), h.ctypes.data_as(_F), len(h),
                             ratio, out.ctypes.data_as(_F), n_out)
    return out.astype(np.float64)


def world_harvest_band_candidates_multi(filt: np.ndarray, offsets: np.ndarray, y_length: int,
                                        fs: float, boundary_f0s: np.ndarray, f0_floor: float,
                                        f0_ceil: float, track_agreement: float,
                                        temporal_positions: np.ndarray) -> np.ndarray:
    """Harvest's raw candidates of a chunk of channels in one call: channel
    ch reads ``filt[ch, offsets[ch] : offsets[ch] + y_length]``. float32
    ``filt`` is read as it is, anything else as float64.
    Returns [n_channels, n_frames]."""
    lib = load()
    n_ch, stride = filt.shape
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    bnds = np.ascontiguousarray(boundary_f0s, dtype=np.float64)
    if offs.shape != (n_ch,) or bnds.shape != (n_ch,) or int(offs.max()) + y_length > stride:
        raise ValueError("offsets and boundaries need one entry per channel, inside its row")
    if filt.dtype == np.float32:
        filt = np.ascontiguousarray(filt)
        fn, data = lib.world_harvest_band_candidates_multi_f, filt.ctypes.data_as(_F)
    else:
        filt = np.ascontiguousarray(filt, dtype=np.float64)
        fn, data = lib.world_harvest_band_candidates_multi, _dp(filt)
    tpos = np.ascontiguousarray(temporal_positions, dtype=np.float64)
    cand = np.empty((n_ch, len(tpos)), np.float64)
    fn(data, n_ch, stride, offs.ctypes.data_as(_I64P), int(y_length), float(fs), _dp(bnds),
       float(f0_floor), float(f0_ceil), float(track_agreement), _dp(tpos), len(tpos), _dp(cand))
    return cand


def world_harvest_remove_unreliable(cands: np.ndarray, scores: np.ndarray,
                                    threshold: float) -> None:
    """Harvest stage 7 in place: drop every candidate without one within
    ``threshold`` (relative) in each neighbouring frame. cands, scores:
    [n_frames, k], float64, C-contiguous."""
    for a in (cands, scores):
        if a.dtype != np.float64 or not a.flags.c_contiguous or a.shape != cands.shape:
            raise ValueError("cands and scores must be C-contiguous float64 of one shape")
    n_frames, k = cands.shape
    load().world_harvest_remove_unreliable(_dp(cands), _dp(scores), n_frames, k, float(threshold))


def world_refine_f0(x: np.ndarray, fs: float, positions: np.ndarray,
                    f0s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Harvest's candidate refinement: (refined f0, reliability score) of each
    (position, f0) pair, from the harmonics' instantaneous frequency."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    f0s = np.ascontiguousarray(f0s, dtype=np.float64)
    if positions.shape != f0s.shape:
        raise ValueError("one position per f0")
    refined = np.empty_like(f0s)
    score = np.empty_like(f0s)
    lib.world_refine_f0(_dp(x), len(x), float(fs), _dp(positions), _dp(f0s), len(f0s),
                        _dp(refined), _dp(score))
    return refined, score

// WORLD's DIO + StoneMask and Harvest F0 estimators (host C++), the PyTorch
// port's copy.
//
// Copied from sovits_tpu/native/world_f0.cpp: the same published algorithms,
// operation for operation, so the port's DIO and Harvest compute the f0 the
// JAX package computes. The JAX package's tests hold that file to its float64
// numpy oracles (tests/test_native.py); the port's tests hold this one to the
// port's numpy copies (f0/world_dio.py, f0/world_harvest.py).
//
// Built by sovits_tpu_torch/native/__init__.py with g++ at first use, without
// -march=native: the library must load on any x86-64 host, not only the one
// that built it.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kEps = 0.000000000001;
constexpr double kMaxScore = 100000.0;
constexpr double kPi = 3.14159265358979323846;

using cplx = std::complex<double>;

// ---------------------------------------------------------------- FFT ----
// iterative radix-2 complex FFT (power-of-two sizes only)
void fft_inplace(std::vector<cplx>& a, bool inverse) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = 2 * kPi / double(len) * (inverse ? 1.0 : -1.0);
    const cplx wlen(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      cplx w(1.0, 0.0);
      for (size_t j = 0; j < len / 2; ++j) {
        cplx u = a[i + j];
        cplx v = a[i + j + len / 2] * w;
        a[i + j] = u + v;
        a[i + j + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    for (auto& v : a) v /= double(n);
  }
}

std::vector<cplx> rfft(const double* x, int n, int fft_size) {
  std::vector<cplx> a(fft_size, cplx(0.0, 0.0));
  for (int i = 0; i < n && i < fft_size; ++i) a[i] = cplx(x[i], 0.0);
  fft_inplace(a, false);
  a.resize(fft_size / 2 + 1);
  return a;
}

std::vector<double> irfft(const std::vector<cplx>& half, int fft_size) {
  std::vector<cplx> a(fft_size);
  for (int i = 0; i <= fft_size / 2; ++i) a[i] = half[i];
  for (int i = 1; i < fft_size / 2; ++i) a[fft_size - i] = std::conj(half[i]);
  fft_inplace(a, true);
  std::vector<double> out(fft_size);
  for (int i = 0; i < fft_size; ++i) out[i] = a[i].real();
  return out;
}

int suitable_fft_size(int n) {
  int s = 1;
  while (s < n) s <<= 1;
  return s;
}

// ---------------------------------------------------------- DIO pieces ----
std::vector<double> nuttall_window(int n) {
  std::vector<double> w(n);
  const double denom = n > 1 ? double(n - 1) : 1.0;
  for (int i = 0; i < n; ++i) {
    const double t = double(i) / denom;
    w[i] = 0.355768 - 0.487396 * std::cos(2 * kPi * t) +
           0.144232 * std::cos(4 * kPi * t) - 0.012604 * std::cos(6 * kPi * t);
  }
  return w;
}

// FFT of the DC-removed signal with a 50 Hz low-cut applied
std::vector<cplx> spectrum_for_estimation(const double* x, int n, int fft_size,
                                          double fs) {
  double mean = 0.0;
  for (int i = 0; i < n; ++i) mean += x[i];
  mean /= double(n);
  std::vector<double> y(n);
  for (int i = 0; i < n; ++i) y[i] = x[i] - mean;
  auto spec = rfft(y.data(), n, fft_size);

  const int cutoff = int(std::llround(fs / 50.0));
  const int m = cutoff * 2 + 1;
  std::vector<double> highpass(m);
  double sum = 0.0;
  for (int i = 0; i < m; ++i) {
    highpass[i] = 0.5 - 0.5 * std::cos(2 * kPi * double(i + 1) / double(m + 1));
    sum += highpass[i];
  }
  for (int i = 0; i < m; ++i) highpass[i] = -highpass[i] / sum;
  highpass[cutoff] += 1.0;
  // rotate so the center tap sits at index 0 (zero-phase)
  std::vector<double> fir(fft_size, 0.0);
  for (int i = 0; i < m; ++i) {
    int j = i - cutoff;
    fir[(j % fft_size + fft_size) % fft_size] = highpass[i];
  }
  auto fir_spec = rfft(fir.data(), fft_size, fft_size);
  for (size_t i = 0; i < spec.size(); ++i) spec[i] *= fir_spec[i];
  return spec;
}

std::vector<double> band_filtered_signal(const std::vector<cplx>& y_spec,
                                         double boundary_f0, double fs,
                                         int fft_size, int y_length) {
  const int half = int(std::llround(fs / boundary_f0 / 2.0));
  const int n = half * 4;
  auto w = nuttall_window(n);
  std::vector<double> fir(fft_size, 0.0);
  for (int i = 0; i < n; ++i) {
    fir[i] = w[i] * std::cos(2 * kPi * boundary_f0 * double(i) / fs);
  }
  auto fir_spec = rfft(fir.data(), fft_size, fft_size);
  for (size_t i = 0; i < fir_spec.size(); ++i) fir_spec[i] *= y_spec[i];
  auto filt = irfft(fir_spec, fft_size);
  std::vector<double> out(y_length);
  for (int i = 0; i < y_length; ++i) out[i] = filt[half * 2 + i];
  return out;
}

struct Track {
  std::vector<double> locations;  // seconds
  std::vector<double> f0;         // Hz
};

Track zero_crossing_track(const std::vector<double>& s, double fs) {
  Track t;
  std::vector<double> fine;
  for (size_t i = 0; i + 1 < s.size(); ++i) {
    if (s[i] > 0.0 && s[i + 1] <= 0.0) {
      fine.push_back(double(i) + s[i] / (s[i] - s[i + 1] + kEps));
    }
  }
  if (fine.size() < 2) return t;
  for (size_t i = 0; i + 1 < fine.size(); ++i) {
    const double interval = fine[i + 1] - fine[i];
    t.locations.push_back(0.5 * (fine[i] + fine[i + 1]) / fs);
    t.f0.push_back(fs / std::max(interval, kEps));
  }
  return t;
}

double interp1(const std::vector<double>& x, const std::vector<double>& y,
               double q) {
  // numpy.interp semantics: clamp outside the range
  if (q <= x.front()) return y.front();
  if (q >= x.back()) return y.back();
  size_t lo = 0, hi = x.size() - 1;
  while (hi - lo > 1) {
    size_t mid = (lo + hi) / 2;
    if (x[mid] <= q) lo = mid; else hi = mid;
  }
  const double w = (q - x[lo]) / (x[hi] - x[lo]);
  return y[lo] * (1.0 - w) + y[hi] * w;
}

void candidate_and_score_for_band(
    const Track tracks[4], double boundary_f0, double f0_floor, double f0_ceil,
    const std::vector<double>& temporal_positions, double* candidate,
    double* score) {
  const int n = int(temporal_positions.size());
  bool usable = true;
  for (int k = 0; k < 4; ++k) {
    if (tracks[k].locations.size() <= 2) usable = false;
  }
  if (!usable) {
    for (int i = 0; i < n; ++i) { candidate[i] = 0.0; score[i] = kMaxScore; }
    return;
  }
  // frame positions ascend, so each track is swept with a cursor instead
  // of a fresh binary search per query — the bracket (and therefore the
  // arithmetic) is identical to interp1's
  size_t cur[4] = {0, 0, 0, 0};
  for (int i = 0; i < n; ++i) {
    const double q = temporal_positions[i];
    double vals[4];
    double mean = 0.0;
    for (int k = 0; k < 4; ++k) {
      const auto& loc = tracks[k].locations;
      const auto& f0v = tracks[k].f0;
      if (q <= loc.front()) {
        vals[k] = f0v.front();
      } else if (q >= loc.back()) {
        vals[k] = f0v.back();
      } else {
        while (cur[k] + 2 < loc.size() && loc[cur[k] + 1] <= q) ++cur[k];
        const size_t lo = cur[k];
        const double w = (q - loc[lo]) / (loc[lo + 1] - loc[lo]);
        vals[k] = f0v[lo] * (1.0 - w) + f0v[lo + 1] * w;
      }
      mean += vals[k];
    }
    mean /= 4.0;
    double dev = 0.0;
    for (int k = 0; k < 4; ++k) dev += (vals[k] - mean) * (vals[k] - mean);
    dev = std::sqrt(dev / 3.0);
    if (mean > boundary_f0 || mean < boundary_f0 / 2.0 || mean > f0_ceil ||
        mean < f0_floor) {
      candidate[i] = 0.0;
      score[i] = kMaxScore;
    } else {
      candidate[i] = mean;
      score[i] = dev;
    }
  }
}

void select_best_f0(double reference, const double* candidates, int n_bands,
                    int stride, double* best, double* best_error) {
  *best = candidates[0];
  *best_error = std::fabs(reference - candidates[0]);
  for (int b = 1; b < n_bands; ++b) {
    const double err = std::fabs(reference - candidates[b * stride]);
    if (err < *best_error) { *best_error = err; *best = candidates[b * stride]; }
  }
}

// Four event tracks (neg/pos crossings, peaks, dips) of one filtered band
// in a single pass over the signal — nothing is materialized. The refined
// positions reproduce zero_crossing_track on the negated/differenced
// signals exactly: fp negation and a-b vs -((-a)-(-b)) are exact.
template <typename T>
void four_tracks(const T* s, int n, double fs, Track tracks[4]) {
  std::vector<double> fine[4];
  const double expect = fs / 2000.0;  // rough events-per-track upper bound
  for (int k = 0; k < 4; ++k) fine[k].reserve(size_t(n / std::max(expect, 4.0)));
  double d_prev = double(s[1]) - double(s[0]);
  for (int i = 0; i + 1 < n; ++i) {
    const double a = double(s[i]), b = double(s[i + 1]);
    if (a > 0.0 && b <= 0.0) fine[0].push_back(i + a / (a - b + kEps));
    if (a < 0.0 && b >= 0.0) fine[1].push_back(i + (-a) / (b - a + kEps));
    if (i + 2 < n) {
      const double d0 = d_prev, d1 = double(s[i + 2]) - b;
      if (d0 > 0.0 && d1 <= 0.0) fine[2].push_back(i + d0 / (d0 - d1 + kEps));
      if (d0 < 0.0 && d1 >= 0.0) fine[3].push_back(i + (-d0) / (d1 - d0 + kEps));
      d_prev = d1;
    }
  }
  for (int k = 0; k < 4; ++k) {
    Track& t = tracks[k];
    const auto& f = fine[k];
    if (f.size() < 2) { t = Track{}; continue; }
    t.locations.resize(f.size() - 1);
    t.f0.resize(f.size() - 1);
    for (size_t i = 0; i + 1 < f.size(); ++i) {
      t.locations[i] = 0.5 * (f[i] + f[i + 1]) / fs;
      t.f0[i] = fs / std::max(f[i + 1] - f[i], kEps);
    }
  }
}

}  // namespace

extern "C" {

// Polyphase FIR decimation (the predictor fast path's MATLAB-decimate
// substitute; linear-phase Kaiser lowpass designed by the Python caller,
// centered so the output is zero-phase like filtfilt). out[m] =
// sum_k h[k] * x[m*ratio + k - nh/2], x zero outside [0, n). Each output
// sample is an independent dot product -> one SIMD reduction per sample.
void world_fir_decimate(const double* x, int64_t n, const double* h,
                        int64_t nh, int64_t ratio, double* out,
                        int64_t n_out) {
  const int64_t half = nh / 2;
  for (int64_t m = 0; m < n_out; ++m) {
    const int64_t start = m * ratio - half;  // x index of h[0]
    int64_t k0 = start < 0 ? -start : 0;
    int64_t k1 = std::min(nh, n - start);
    double acc = 0.0;
    const double* xs = x + start;
#pragma omp simd reduction(+ : acc)
    for (int64_t k = k0; k < k1; ++k) acc += h[k] * xs[k];
    out[m] = acc;
  }
}

// float32 variant, 4 outputs per iteration (shared h loads, 4 independent
// FMA chains). ~1e-5-relative rounding vs the f64 path — inside the fast
// path's tolerance (band filtering is float32 anyway).
void world_fir_decimate_f(const float* x, int64_t n, const float* h,
                          int64_t nh, int64_t ratio, float* out,
                          int64_t n_out) {
  const int64_t half = nh / 2;
  int64_t m = 0;
  // interior block: all four dot products fully inside [0, n)
  const int64_t m_lo = std::min(n_out, (half + ratio - 1) / ratio);
  const int64_t m_hi_raw = (n - nh + half) / ratio;  // start+nh<=n
  const int64_t m_hi = std::max(m_lo, std::min(n_out, m_hi_raw));
  for (m = 0; m < m_lo; ++m) {
    const int64_t start = m * ratio - half;
    int64_t k0 = start < 0 ? -start : 0;
    int64_t k1 = std::min(nh, n - start);
    float acc = 0.0f;
    const float* xs = x + start;
#pragma omp simd reduction(+ : acc)
    for (int64_t k = k0; k < k1; ++k) acc += h[k] * xs[k];
    out[m] = acc;
  }
  for (; m + 4 <= m_hi; m += 4) {
    const float* x0 = x + m * ratio - half;
    const float* x1 = x0 + ratio;
    const float* x2 = x1 + ratio;
    const float* x3 = x2 + ratio;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma omp simd reduction(+ : a0, a1, a2, a3)
    for (int64_t k = 0; k < nh; ++k) {
      const float hk = h[k];
      a0 += hk * x0[k];
      a1 += hk * x1[k];
      a2 += hk * x2[k];
      a3 += hk * x3[k];
    }
    out[m] = a0; out[m + 1] = a1; out[m + 2] = a2; out[m + 3] = a3;
  }
  for (; m < n_out; ++m) {
    const int64_t start = m * ratio - half;
    int64_t k0 = start < 0 ? -start : 0;
    int64_t k1 = std::min(nh, n - start);
    float acc = 0.0f;
    const float* xs = x + start;
#pragma omp simd reduction(+ : acc)
    for (int64_t k = k0; k < k1; ++k) acc += h[k] * xs[k];
    out[m] = acc;
  }
}

// tracks + interpolation + candidate/score for one band-filtered signal
// (the loop-heavy middle of DIO; filtering stays in the caller)
void world_band_candidates(const double* filtered, int64_t y_length, double fs,
                           double boundary_f0, double f0_floor, double f0_ceil,
                           const double* temporal_positions, int64_t n_frames,
                           double* candidate, double* score) {
  Track tracks[4];
  four_tracks(filtered, int(y_length), fs, tracks);
  std::vector<double> tpos(temporal_positions, temporal_positions + n_frames);
  candidate_and_score_for_band(tracks, boundary_f0, f0_floor, f0_ceil, tpos,
                               candidate, score);
}

// float32 variant (the fast filtering path hands over float32 bands)
void world_band_candidates_f(const float* filtered, int64_t y_length,
                             double fs, double boundary_f0, double f0_floor,
                             double f0_ceil, const double* temporal_positions,
                             int64_t n_frames, double* candidate,
                             double* score) {
  Track tracks[4];
  four_tracks(filtered, int(y_length), fs, tracks);
  std::vector<double> tpos(temporal_positions, temporal_positions + n_frames);
  candidate_and_score_for_band(tracks, boundary_f0, f0_floor, f0_ceil, tpos,
                               candidate, score);
}

// Harvest's per-channel raw candidate contour (world_harvest.py
// _band_candidate_from_filtered): mean of the four event tracks at each
// frame, gated on +-10% of the channel boundary, the f0 bounds, and the
// four tracks agreeing within track_agreement of the candidate.
extern "C++" {  // template: C++ linkage island inside the extern "C" block
template <typename T>
static void harvest_band_candidates_impl(const T* filtered, int64_t y_length,
                                         double fs, double boundary_f0,
                                         double f0_floor, double f0_ceil,
                                         double track_agreement,
                                         const double* temporal_positions,
                                         int64_t n_frames, double* candidate) {
  Track tracks[4];
  four_tracks(filtered, int(y_length), fs, tracks);
  for (int k = 0; k < 4; ++k) {
    if (tracks[k].locations.size() <= 2) {
      for (int64_t i = 0; i < n_frames; ++i) candidate[i] = 0.0;
      return;
    }
  }
  // frame positions ascend, so each track is swept with a cursor instead
  // of a fresh binary search per query (same bracket, same arithmetic)
  size_t cur[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < n_frames; ++i) {
    const double q = temporal_positions[i];
    double vals[4];
    double mean = 0.0;
    for (int k = 0; k < 4; ++k) {
      const auto& loc = tracks[k].locations;
      const auto& f0v = tracks[k].f0;
      while (cur[k] + 2 < loc.size() && loc[cur[k] + 1] <= q) ++cur[k];
      if (q <= loc.front()) {
        vals[k] = f0v.front();
      } else if (q >= loc.back()) {
        vals[k] = f0v.back();
      } else {
        const size_t lo = cur[k];
        const double w = (q - loc[lo]) / (loc[lo + 1] - loc[lo]);
        vals[k] = f0v[lo] * (1.0 - w) + f0v[lo + 1] * w;
      }
      mean += vals[k];
    }
    mean /= 4.0;
    double dev = 0.0;
    for (int k = 0; k < 4; ++k) dev = std::max(dev, std::fabs(vals[k] - mean));
    const bool bad = mean > boundary_f0 * 1.1 || mean < boundary_f0 * 0.9 ||
                     mean > f0_ceil || mean < f0_floor ||
                     dev > mean * track_agreement;
    candidate[i] = bad ? 0.0 : mean;
  }
}
}  // extern "C++"

void world_harvest_band_candidates(const double* filtered, int64_t y_length,
                                   double fs, double boundary_f0,
                                   double f0_floor, double f0_ceil,
                                   double track_agreement,
                                   const double* temporal_positions,
                                   int64_t n_frames, double* candidate) {
  harvest_band_candidates_impl(filtered, y_length, fs, boundary_f0, f0_floor,
                               f0_ceil, track_agreement, temporal_positions,
                               n_frames, candidate);
}

// Multi-channel variants: one call for a whole chunk of band-filtered
// channels (filtered[ch] starts at base + ch*stride + offsets[ch]) —
// amortizes the per-call ctypes/copy overhead of the 160+ channel Harvest
// loop into one crossing. The float32 form consumes the fast path's
// filtered chunks without an f64 staging copy.
void world_harvest_band_candidates_multi(
    const double* base, int64_t n_channels, int64_t stride,
    const int64_t* offsets, int64_t y_length, double fs,
    const double* boundary_f0s, double f0_floor, double f0_ceil,
    double track_agreement, const double* temporal_positions,
    int64_t n_frames, double* candidates /* [n_channels, n_frames] */) {
  for (int64_t ch = 0; ch < n_channels; ++ch) {
    harvest_band_candidates_impl(
        base + ch * stride + offsets[ch], y_length, fs, boundary_f0s[ch],
        f0_floor, f0_ceil, track_agreement, temporal_positions, n_frames,
        candidates + ch * n_frames);
  }
}

void world_harvest_band_candidates_multi_f(
    const float* base, int64_t n_channels, int64_t stride,
    const int64_t* offsets, int64_t y_length, double fs,
    const double* boundary_f0s, double f0_floor, double f0_ceil,
    double track_agreement, const double* temporal_positions,
    int64_t n_frames, double* candidates /* [n_channels, n_frames] */) {
  for (int64_t ch = 0; ch < n_channels; ++ch) {
    harvest_band_candidates_impl(
        base + ch * stride + offsets[ch], y_length, fs, boundary_f0s[ch],
        f0_floor, f0_ceil, track_agreement, temporal_positions, n_frames,
        candidates + ch * n_frames);
  }
}

// Harvest stage 7 (world_harvest.py _remove_unreliable), in place over
// cands/scores [n_frames, k]: a live candidate survives only if each
// EXISTING neighbour frame holds some candidate within `threshold` of it.
// Agreement is checked against a snapshot (removals must not cascade along
// time); empty slots carry a large sentinel so an empty neighbour frame
// yields a huge deviation and kills the whole frame, exactly as the numpy
// oracle's sentinel-sort does.
void world_harvest_remove_unreliable(double* cands, double* scores,
                                     int64_t n_frames, int64_t k,
                                     double threshold) {
  const double kEmptySentinel = 100000.0;  // > any f0 (< f0_ceil ~1.1e3)
  std::vector<double> frozen(cands, cands + size_t(n_frames) * k);
  std::vector<double> sorted(size_t(n_frames) * k);
  for (int64_t t = 0; t < n_frames; ++t) {
    double* row = &sorted[size_t(t) * k];
    for (int64_t j = 0; j < k; ++j) {
      const double v = frozen[size_t(t) * k + j];
      row[j] = v > 0.0 ? v : kEmptySentinel;
    }
    std::sort(row, row + k);
  }
  for (int64_t t = 0; t < n_frames; ++t) {
    for (int64_t j = 0; j < k; ++j) {
      const double cur = frozen[size_t(t) * k + j];
      if (cur <= 0.0) continue;
      bool ok = true;
      for (int dt = -1; dt <= 1 && ok; dt += 2) {
        const int64_t nt = t + dt;
        if (nt < 0 || nt >= n_frames) continue;  // no constraint
        const double* row = &sorted[size_t(nt) * k];
        const double* hi = std::lower_bound(row, row + k, cur);
        const double hi_v = hi <= row + k - 1 ? *hi : row[k - 1];
        const double lo_v = hi - 1 >= row ? *(hi - 1) : row[0];
        const double near = std::min(std::fabs(hi_v - cur),
                                     std::fabs(cur - lo_v));
        ok = near / (cur + kEps) <= threshold;
      }
      if (!ok) {
        cands[size_t(t) * k + j] = 0.0;
        scores[size_t(t) * k + j] = 0.0;
      }
    }
  }
}

// the four contour-fixing passes over the best-candidate contour
// (candidates laid out [band][frame], stride n_frames between bands)
void world_fix_steps(const double* best, const double* candidates,
                     int64_t n_bands, int64_t n_frames, double frame_period_ms,
                     double f0_floor, double allowed_range, double* f0_out) {
  const int nf = int(n_frames), nb = int(n_bands);
  const int vrm = int(0.5 + 1000.0 / frame_period_ms / f0_floor) * 2 + 1;
  if (nf <= 2 * vrm) {
    std::memcpy(f0_out, best, sizeof(double) * nf);
    return;
  }
  std::vector<double> base(best, best + nf);
  for (int i = 0; i < vrm && i < nf; ++i) base[i] = 0.0;
  for (int i = std::max(nf - vrm, 0); i < nf; ++i) base[i] = 0.0;
  std::vector<double> step1(nf, 0.0);
  for (int i = vrm; i < nf; ++i) {
    if (std::fabs((base[i] - base[i - 1]) / (kEps + base[i])) < allowed_range) {
      step1[i] = base[i];
    }
  }
  std::vector<double> step2 = step1;
  const int half = vrm / 2;
  for (int i = half; i < nf - half; ++i) {
    for (int j = -half; j <= half; ++j) {
      if (step1[i + j] == 0.0) { step2[i] = 0.0; break; }
    }
  }
  std::vector<double> step3 = step2;
  for (int i = 0; i + 1 < nf; ++i) {
    if (step3[i] != 0.0 && step3[i + 1] == 0.0) {
      for (int j = i + 1; j < nf; ++j) {
        double cand, err;
        select_best_f0(step3[j - 1], &candidates[j], nb, nf, &cand, &err);
        if (err / (step3[j - 1] + kEps) < allowed_range && cand != 0.0) {
          step3[j] = cand;
        } else {
          break;
        }
      }
    }
  }
  std::vector<double> step4 = step3;
  for (int i = nf - 1; i > 0; --i) {
    if (step4[i] != 0.0 && step4[i - 1] == 0.0) {
      for (int j = i - 1; j >= 0; --j) {
        double cand, err;
        select_best_f0(step4[j + 1], &candidates[j], nb, nf, &cand, &err);
        if (err / (step4[j + 1] + kEps) < allowed_range && cand != 0.0) {
          step4[j] = cand;
        } else {
          break;
        }
      }
    }
  }
  std::memcpy(f0_out, step4.data(), sizeof(double) * nf);
}

int world_dio_f0_length(int64_t x_length, double fs, double frame_period_ms) {
  return int(double(x_length) / fs * 1000.0 / frame_period_ms) + 1;
}

void world_dio(const double* x, int64_t x_length, double fs,
               double frame_period_ms, double f0_floor, double f0_ceil,
               double channels_in_octave, double allowed_range,
               double* temporal_positions, double* f0_out) {
  const int n_bands =
      1 + int(std::log2(f0_ceil / f0_floor) * channels_in_octave);
  std::vector<double> boundaries(n_bands);
  for (int b = 0; b < n_bands; ++b) {
    boundaries[b] = f0_floor * std::pow(2.0, double(b + 1) / channels_in_octave);
  }

  const int y_length = int(x_length);
  const int n_frames = world_dio_f0_length(x_length, fs, frame_period_ms);
  std::vector<double> tpos(n_frames);
  for (int i = 0; i < n_frames; ++i) tpos[i] = i * frame_period_ms / 1000.0;
  std::memcpy(temporal_positions, tpos.data(), sizeof(double) * n_frames);

  const int fft_size = suitable_fft_size(
      y_length + int(std::llround(fs / 50.0)) * 2 + 1 +
      4 * int(1.0 + fs / boundaries[0] / 2.0));
  auto y_spec = spectrum_for_estimation(x, y_length, fft_size, fs);

  std::vector<double> candidates(size_t(n_bands) * n_frames, 0.0);
  std::vector<double> scores(size_t(n_bands) * n_frames, kMaxScore);
  for (int b = 0; b < n_bands; ++b) {
    auto filtered =
        band_filtered_signal(y_spec, boundaries[b], fs, fft_size, y_length);
    std::vector<double> d(filtered.size() - 1);
    for (size_t i = 0; i + 1 < filtered.size(); ++i) d[i] = filtered[i + 1] - filtered[i];
    std::vector<double> neg_d(d.size());
    for (size_t i = 0; i < d.size(); ++i) neg_d[i] = -d[i];
    std::vector<double> neg(filtered.size());
    for (size_t i = 0; i < filtered.size(); ++i) neg[i] = -filtered[i];
    Track tracks[4] = {
        zero_crossing_track(filtered, fs),
        zero_crossing_track(neg, fs),
        zero_crossing_track(d, fs),
        zero_crossing_track(neg_d, fs),
    };
    candidate_and_score_for_band(tracks, boundaries[b], f0_floor, f0_ceil,
                                 tpos, &candidates[size_t(b) * n_frames],
                                 &scores[size_t(b) * n_frames]);
  }

  std::vector<double> best(n_frames, 0.0);
  for (int i = 0; i < n_frames; ++i) {
    int best_b = 0;
    double best_rel =
        scores[i] / (candidates[i] + kEps);
    for (int b = 1; b < n_bands; ++b) {
      const double rel = scores[size_t(b) * n_frames + i] /
                         (candidates[size_t(b) * n_frames + i] + kEps);
      if (rel < best_rel) { best_rel = rel; best_b = b; }
    }
    best[i] = scores[size_t(best_b) * n_frames + i] >= kMaxScore
                  ? 0.0
                  : candidates[size_t(best_b) * n_frames + i];
  }

  const int vrm = int(0.5 + 1000.0 / frame_period_ms / f0_floor) * 2 + 1;
  if (n_frames <= 2 * vrm) {
    std::memcpy(f0_out, best.data(), sizeof(double) * n_frames);
    return;
  }

  // FixStep1: step detection
  std::vector<double> base = best;
  for (int i = 0; i < vrm && i < n_frames; ++i) base[i] = 0.0;
  for (int i = std::max(n_frames - vrm, 0); i < n_frames; ++i) base[i] = 0.0;
  std::vector<double> step1(n_frames, 0.0);
  for (int i = vrm; i < n_frames; ++i) {
    if (std::fabs((base[i] - base[i - 1]) / (kEps + base[i])) < allowed_range) {
      step1[i] = base[i];
    }
  }
  // FixStep2: remove short voiced runs
  std::vector<double> step2 = step1;
  const int half = vrm / 2;
  for (int i = half; i < n_frames - half; ++i) {
    for (int j = -half; j <= half; ++j) {
      if (step1[i + j] == 0.0) { step2[i] = 0.0; break; }
    }
  }
  // FixStep3: forward extension by candidates
  std::vector<double> step3 = step2;
  for (int i = 0; i + 1 < n_frames; ++i) {
    if (step3[i] != 0.0 && step3[i + 1] == 0.0) {
      for (int j = i + 1; j < n_frames; ++j) {
        double cand, err;
        // candidates laid out [band][frame]; stride between bands = n_frames
        select_best_f0(step3[j - 1], &candidates[j], n_bands, n_frames, &cand,
                       &err);
        if (err / (step3[j - 1] + kEps) < allowed_range && cand != 0.0) {
          step3[j] = cand;
        } else {
          break;
        }
      }
    }
  }
  // FixStep4: backward extension
  std::vector<double> step4 = step3;
  for (int i = n_frames - 1; i > 0; --i) {
    if (step4[i] != 0.0 && step4[i - 1] == 0.0) {
      for (int j = i - 1; j >= 0; --j) {
        double cand, err;
        select_best_f0(step4[j + 1], &candidates[j], n_bands, n_frames, &cand,
                       &err);
        if (err / (step4[j + 1] + kEps) < allowed_range && cand != 0.0) {
          step4[j] = cand;
        } else {
          break;
        }
      }
    }
  }
  std::memcpy(f0_out, step4.data(), sizeof(double) * n_frames);
}

// Main+diff spectra of the windowed segment, evaluated at the <=6 harmonic
// DFT bins in ONE pass over the window. Each harmonic's rotation recurrence
// is lane-independent, so the k-loop vectorizes (padded to 8 lanes) and
// wm/wd are streamed once instead of once per harmonic — same per-harmonic
// op sequence as the scalar formulation (bit-identical results), ~4x less
// work overall.
static void harmonic_bins(const double* wm, const double* wd, int wlen,
                          const int* bins, int nh, int fft_size,
                          double* mr_out, double* mi_out, double* dr_out,
                          double* di_out) {
  // 4 interleaved streams (i mod 4), each advancing its phasor by the
  // 4-step rotation e^{-i 4 ang} with its own accumulator set: the single
  // -stream version serializes on the rotation recurrence's FMA latency
  // (~8 cycles per sample regardless of SIMD width); 4 independent chains
  // keep the FMA pipes full. Accumulation order changes (4 partial sums),
  // error stays ~n*eps — the refine/stonemask tests are Hz-tolerance
  // gated, not bit-pinned. Harvest end-to-end 722 -> 564 ms (1-core VM).
  constexpr int kLanes = 8;
  constexpr int kStreams = 4;
  double cs4[kLanes], sn4[kLanes];
  double er[kStreams][kLanes], ei[kStreams][kLanes];
  double mr[kStreams][kLanes] = {{0}}, mi[kStreams][kLanes] = {{0}},
         dr[kStreams][kLanes] = {{0}}, di[kStreams][kLanes] = {{0}};
  for (int k = 0; k < kLanes; ++k) {
    const double ang =
        k < nh ? 2 * kPi * double(bins[k]) / double(fft_size) : 0.0;
    cs4[k] = std::cos(4.0 * ang);
    sn4[k] = -std::sin(4.0 * ang);  // (e^{-i ang})^4 step
    for (int s = 0; s < kStreams; ++s) {
      er[s][k] = std::cos(double(s) * ang);
      ei[s][k] = -std::sin(double(s) * ang);
    }
  }
  int i = 0;
  for (; i + kStreams <= wlen; i += kStreams) {
    for (int s = 0; s < kStreams; ++s) {
      const double m = wm[i + s], d = wd[i + s];
#pragma omp simd
      for (int k = 0; k < kLanes; ++k) {
        mr[s][k] += m * er[s][k];
        mi[s][k] += m * ei[s][k];
        dr[s][k] += d * er[s][k];
        di[s][k] += d * ei[s][k];
        const double nr = er[s][k] * cs4[k] - ei[s][k] * sn4[k];
        ei[s][k] = er[s][k] * sn4[k] + ei[s][k] * cs4[k];
        er[s][k] = nr;
      }
    }
  }
  for (int s = 0; i + s < wlen; ++s) {  // tail: stream s phasor is current
    const double m = wm[i + s], d = wd[i + s];
#pragma omp simd
    for (int k = 0; k < kLanes; ++k) {
      mr[s][k] += m * er[s][k];
      mi[s][k] += m * ei[s][k];
      dr[s][k] += d * er[s][k];
      di[s][k] += d * ei[s][k];
    }
  }
  for (int k = 0; k < nh; ++k) {
    mr_out[k] = mr[0][k] + mr[1][k] + mr[2][k] + mr[3][k];
    mi_out[k] = mi[0][k] + mi[1][k] + mi[2][k] + mi[3][k];
    dr_out[k] = dr[0][k] + dr[1][k] + dr[2][k] + dr[3][k];
    di_out[k] = di[0][k] + di[1][k] + di[2][k] + di[3][k];
  }
}

// GetMeanF0 without the per-frame FFT: only the <=6 harmonic bins of the
// windowed-segment spectra are ever read, so each is evaluated directly as
// a DFT sum with a rotation recurrence (error ~n*eps, well under the parity
// tolerance); the Blackman window is likewise generated by recurrence
// (cos(4pi p) = 2 cos^2(2pi p) - 1). ~40x less work per frame than the
// radix-2 FFT formulation at typical voice f0.
static double get_mean_f0(const double* x, int64_t x_length, double fs,
                          double current_position, double current_f0,
                          std::vector<double>& wm, std::vector<double>& wd,
                          std::vector<double>& win) {
  const int half_window = int(1.5 * fs / current_f0 + 1.0);
  const int wlen = 2 * half_window + 1;
  int fft_size = 1;
  {
    int log2n = 0;
    while ((1 << log2n) < wlen) ++log2n;
    fft_size = 1 << (2 + log2n);
  }
  const int n_harmonics = std::min(int(fs / 2.0 / current_f0), 6);
  if (n_harmonics < 1) return 0.0;

  // main window by rotation recurrence over position (i + 0.5) / wlen
  wm.resize(wlen);
  wd.resize(wlen);
  std::vector<double>& main_window = win;
  // window is a pure function of wlen: successive frames share it whenever
  // their rounded half-window matches (smooth f0 contours hit this often)
  if (int(win.size()) != wlen) {
    win.resize(wlen);
    const double step = 2 * kPi / double(wlen);
    const double cs = std::cos(step), sn = std::sin(step);
    double cr = std::cos(0.5 * step), ci = std::sin(0.5 * step);
    for (int i = 0; i < wlen; ++i) {
      main_window[i] = 0.42 - 0.5 * cr + 0.08 * (2.0 * cr * cr - 1.0);
      const double nr = cr * cs - ci * sn;
      ci = cr * sn + ci * cs;
      cr = nr;
    }
  }
  // segment (integer-offset sample indexing, as the numpy oracle), staged
  // in wm; wd = segment * diff-window, then wm *= main-window in place
  const int64_t base_idx = int64_t(std::llround(current_position * fs + 0.001));
  for (int i = 0; i < wlen; ++i) {
    int64_t idx = base_idx + int64_t(i - half_window);
    idx = std::min<int64_t>(std::max<int64_t>(idx, 0), x_length - 1);
    wm[i] = x[idx];
  }
  for (int i = 1; i + 1 < wlen; ++i) {
    wd[i] = wm[i] * (-(main_window[i + 1] - main_window[i - 1]) / 2.0);
  }
  wd[0] = wm[0] * (-main_window[1] / 2.0);
  wd[wlen - 1] = wm[wlen - 1] * (main_window[wlen - 2] / 2.0);
  for (int i = 0; i < wlen; ++i) wm[i] *= main_window[i];

  int bins[6];
  for (int k = 1; k <= n_harmonics; ++k) {
    bins[k - 1] = int(std::llround(current_f0 * k * fft_size / fs));
  }
  double mr[6], mi[6], dr[6], di[6];
  harmonic_bins(wm.data(), wd.data(), wlen, bins, n_harmonics, fft_size, mr,
                mi, dr, di);
  double num = 0.0, den = 0.0;
  for (int k = 1; k <= n_harmonics; ++k) {
    const double power = mr[k - 1] * mr[k - 1] + mi[k - 1] * mi[k - 1] + kEps;
    const double inst_freq =
        double(bins[k - 1]) * fs / fft_size +
        (mr[k - 1] * di[k - 1] - mi[k - 1] * dr[k - 1]) / power * fs /
            (2.0 * kPi);
    const double amp = std::sqrt(power);
    num += inst_freq * amp;
    den += amp * double(k);
  }
  return num / (den + kEps);
}

// GetRefinedF0 for Harvest: like get_mean_f0 but also returns a
// reliability score = 1 / (amp-weighted mean relative deviation of the
// per-harmonic instantaneous f0 from the refined estimate).
static void refine_one(const double* x, int64_t x_length, double fs,
                       double current_position, double current_f0,
                       double* refined, double* score,
                       std::vector<double>& wm, std::vector<double>& wd,
                       std::vector<double>& win) {
  *refined = 0.0;
  *score = 0.0;
  const int half_window = int(1.5 * fs / current_f0 + 1.0);
  const int wlen = 2 * half_window + 1;
  int fft_size = 1;
  {
    int log2n = 0;
    while ((1 << log2n) < wlen) ++log2n;
    fft_size = 1 << (2 + log2n);
  }
  const int n_harmonics = std::min(int(fs / 2.0 / current_f0), 6);
  if (n_harmonics < 1) return;

  wm.resize(wlen); wd.resize(wlen);
  if (int(win.size()) != wlen) {  // pure function of wlen: cache across frames
    win.resize(wlen);
    const double step = 2 * kPi / double(wlen);
    const double cs = std::cos(step), sn = std::sin(step);
    double cr = std::cos(0.5 * step), ci = std::sin(0.5 * step);
    for (int i = 0; i < wlen; ++i) {
      win[i] = 0.42 - 0.5 * cr + 0.08 * (2.0 * cr * cr - 1.0);
      const double nr = cr * cs - ci * sn;
      ci = cr * sn + ci * cs;
      cr = nr;
    }
  }
  const int64_t base_idx = int64_t(std::llround(current_position * fs + 0.001));
  for (int i = 0; i < wlen; ++i) {
    int64_t idx = base_idx + int64_t(i - half_window);
    idx = std::min<int64_t>(std::max<int64_t>(idx, 0), x_length - 1);
    wm[i] = x[idx];
  }
  for (int i = 1; i + 1 < wlen; ++i) {
    wd[i] = wm[i] * (-(win[i + 1] - win[i - 1]) / 2.0);
  }
  wd[0] = wm[0] * (-win[1] / 2.0);
  wd[wlen - 1] = wm[wlen - 1] * (win[wlen - 2] / 2.0);
  for (int i = 0; i < wlen; ++i) wm[i] *= win[i];

  int bins[6];
  for (int k = 1; k <= n_harmonics; ++k) {
    bins[k - 1] = int(std::llround(current_f0 * k * fft_size / fs));
  }
  double mr[6], mi[6], dr[6], di[6];
  harmonic_bins(wm.data(), wd.data(), wlen, bins, n_harmonics, fft_size, mr,
                mi, dr, di);
  double inst[6], amp[6];
  double num = 0.0, den = 0.0;
  for (int k = 1; k <= n_harmonics; ++k) {
    const double power = mr[k - 1] * mr[k - 1] + mi[k - 1] * mi[k - 1] + kEps;
    inst[k - 1] =
        double(bins[k - 1]) * fs / fft_size +
        (mr[k - 1] * di[k - 1] - mi[k - 1] * dr[k - 1]) / power * fs /
            (2.0 * kPi);
    amp[k - 1] = std::sqrt(power);
    num += inst[k - 1] * amp[k - 1];
    den += amp[k - 1] * double(k);
  }
  const double r = num / (den + kEps);
  double dev = 0.0, asum = 0.0, amax = 0.0;
  for (int k = 1; k <= n_harmonics; ++k) {
    dev += amp[k - 1] * std::fabs(inst[k - 1] / double(k) - r) / (r + kEps);
    asum += amp[k - 1];
    amax = std::max(amax, amp[k - 1]);
  }
  *refined = r;
  // fundamental-strength weighting: a subharmonic of a real tone explains
  // the harmonic stack with near-zero IF deviation but has only noise in
  // its own fundamental slot — scale reliability by amp(k=1)/max(amp).
  *score = (amp[0] / (amax + kEps)) / (dev / (asum + kEps) + kEps);
}

void world_refine_f0(const double* x, int64_t x_length, double fs,
                     const double* positions, const double* f0s, int64_t n,
                     double* refined_out, double* score_out) {
  std::vector<double> wm, wd, win;
  // candidates are independent: process in window-length order so the
  // wlen-keyed Blackman cache in refine_one rebuilds once per distinct
  // length instead of (nearly) once per candidate. Outputs land at their
  // original indices — identical results, any order.
  std::vector<int64_t> order(n);
  std::vector<int> wl(n);
  for (int64_t i = 0; i < n; ++i) {
    order[i] = i;
    const double f = f0s[i] > 0.0 ? f0s[i] : 1.0;
    wl[i] = 2 * int(1.5 * fs / f + 1.0) + 1;
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return wl[a] < wl[b]; });
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[k];
    refine_one(x, x_length, fs, positions[i], f0s[i], &refined_out[i],
               &score_out[i], wm, wd, win);
  }
}

void world_stonemask(const double* x, int64_t x_length, double fs,
                     const double* temporal_positions, const double* f0_in,
                     int64_t f0_length, double* f0_out) {
  std::vector<double> wm, wd, win;
  for (int64_t i = 0; i < f0_length; ++i) {
    const double f = f0_in[i];
    if (f == 0.0) { f0_out[i] = 0.0; continue; }
    double mean_f0 =
        get_mean_f0(x, x_length, fs, temporal_positions[i], f, wm, wd, win);
    if (std::fabs(mean_f0 - f) <= f * 0.2 && mean_f0 > 0.0) {
      mean_f0 = get_mean_f0(x, x_length, fs, temporal_positions[i], mean_f0,
                            wm, wd, win);
    }
    f0_out[i] = mean_f0 > 0.0 ? mean_f0 : f;
  }
}

}  // extern "C"

// Backward of the fused relative-position self-attention (rel_attention.cu),
// fp32 or bf16 in and out.
//
// Replaces the TPU kernel sovits_tpu/ops/attention.py:_make_fused.bwd_rule
// (Pallas body _bwd_kernel). On [BH, T, D] with q pre-scaled by 1/sqrt(D),
// the forward's out and per-row log-sum-exp lse, the incoming dout and the
// optional dropout mask dm (keep/(1-rate), [BH, T, T]):
//   p       = exp(s - lse), s replayed with the forward's masks (replacement
//             by -1e4), so p is the TPU kernel's stored p, masked rows too
//   pt      = p * dm
//   dv      = pt^T . dout
//   g       = (dout . v^T + band of dout . rel_v^T) * dm
//   D[t]    = sum_u g[t, u] p[t, u]
//   ds      = p * (g - D)
//   dq      = ds . k + band(ds) . rel_k
//   dk      = ds^T . q
//   drel_k  = sum_t band(ds)[t] q[t],  drel_v = sum_t band(pt)[t] dout[t]
//
// Types. q, k, v, the rel tables, out, dout, dq, dk and dv are all fp32 or
// all bf16; lse, the masks, the scratch and the rel-table partials are fp32.
// Every value is widened to fp32 where it is staged in shared memory, so
// products of two bf16 values are exact and every sum is fp32. In bf16 the
// kernel rounds where the TPU kernel does (_bwd_kernel in q's type): p to
// bf16 (its stored p_lo) before anything uses it; pt = p dm, and ds, to bf16
// before they enter a product (dv, dq, dk and both band terms); g, D and
// ds themselves stay fp32. dq, dk and dv are rounded once, at the store.
// In fp32 every rounding is the identity.
//
// D, by type:
//   fp32: D = dout[t] . out[t] (the same number summed in another order):
//     out[t] = sum_u pt[t, u] v[u] + sum_o pt-band[t, o] rel_v[o], so dout[t]
//     . out[t] = sum_u p[t, u] dm[t, u] (dout[t] . v[u] + band term) = sum_u p g.
//   bf16: route (b), a sweep over the keys. out is bf16, rounded after its
//     sum, so dout . out is not sum_u p g: on a row with one key (causal row
//     0, the F0Decoder) ds = p (g - D) would no longer cancel to 0 and that
//     row's dq would be rounding noise. Pass (a) therefore first sweeps the
//     key tiles once, recomputing p (rounded) and g, and sums g p per row in
//     fp32, as the TPU kernel does; out is not read. That costs the score
//     and dout . v^T products once more (9 products of 2 T^2 D where 7 run in
//     fp32), and keeps K1 and its fp32 output untouched.
// Like the TPU kernel, masked positions are not replayed in ds: ds is p
// times (g - D) wherever p is not 0, which matters only on a row whose keys
// are all masked (uniform p).
//
// Blocks run in no order, so nothing is carried across the grid and no
// atomics are used; two passes, each deterministic:
//   (a) rel_attn_bwd_q: one block per (bh, 32 query rows) streams the key
//       tiles and computes dq, D (bf16: in a first sweep), and the per-block
//       partials of drel_k and drel_v (sums over query rows). The partials
//       go to a scratch array [n_blocks, 2, 2w+1, D] that the caller sums
//       (as the JAX package sums its per-program partials). It also stores
//       D, and q . rel_k and dout . rel_v per row ([BH, T, 2 (2w+1)]), for
//       pass (b).
//   (b) rel_attn_bwd_kv: one block per (bh, 64 keys) streams the query
//       tiles and computes dk and dv.
// Causal without a key mask (the F0Decoder), every row has a valid key at
// or before its diagonal, so a key above the diagonal has p = exp(-1e4 -
// lse) = 0 exactly in fp32 (and in bf16): those tiles are skipped, in every
// sweep. With a key mask they are not (a fully masked row is uniform over
// all keys).
//
// What bounds it on an H100: 7 products of 2 T^2 D per (bh) as written in
// fp32, 9 in bf16 (the algorithm needs 5; the score and dout . v^T products
// run in both passes, and in bf16's D sweep), in fp32 FMA loops from shared
// memory, against about 0.1 GB of traffic at the training shape (BH 12,
// T 800, D 96, with the 30.7 MB dropout mask read once per sweep):
// operation-bound on the fp32 pipes, in both types (bf16 saves only bytes,
// which do not bind). Tiles live in shared memory as fp32 (about 95 KB a
// block at D = 96, two blocks an SM) with row strides padded by one word.
// Tensor cores, TMA and an in-kernel Philox mask are later work.
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "dtype.cuh"

namespace {

constexpr int BQ = 32;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int MAXD = 128;
constexpr int DJ = MAXD / 16;  // feature columns per thread at most
constexpr float NEG = -1e4f;   // the reference's masking constant

// Scores s and dout . v^T for rows (ty, ty + 16) of the query tile and keys
// (tx + 16 j) of the key tile, then per entry p (rounded to T_), pt = p dm
// and ds. kRowSum: only D's row sums, dsum[i] += g p (bf16's D sweep); s and
// g are left as they are. Otherwise in place, rounded to T_ as the products
// that take them want: s[i][j] <- pt, g[i][j] <- ds (0 outside the sequence).
template <typename T_, bool kRowSum>
__device__ __forceinline__ void tile_ds(
    const float* sq, const float* sdo, const float* sk, const float* sv, const float* srl,
    const float* sgr, const float* s_lse, const float* s_D, const float* km, const float* dm,
    int q0, int k0, int T, int D, int ld, int window, int win, int causal, int tx, int ty,
    float s[2][4], float g[2][4], float dsum[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.f;
  for (int c = 0; c < D; ++c) {
    const float a0 = sq[ty * ld + c], a1 = sq[(ty + 16) * ld + c];
    const float d0 = sdo[ty * ld + c], d1 = sdo[(ty + 16) * ld + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float kk = sk[(tx + 16 * j) * ld + c];
      const float vv = sv[(tx + 16 * j) * ld + c];
      s[0][j] = fmaf(a0, kk, s[0][j]);
      s[1][j] = fmaf(a1, kk, s[1][j]);
      g[0][j] = fmaf(d0, vv, g[0][j]);
      g[1][j] = fmaf(d1, vv, g[1][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = k0 + tx + 16 * j;
      float pt = 0.f, ds = 0.f;
      if (t < T && u < T) {
        const int off = u - t;
        float x = s[i][j], gg = g[i][j];
        if (win && off >= -window && off <= window) {
          x += srl[r * win + off + window];
          gg += sgr[r * win + off + window];
        }
        if (causal && off > 0) x = NEG;
        if (km && !(km[u] > 0.f)) x = NEG;
        const float p = round_to<T_>(expf(x - s_lse[r]));  // the TPU kernel's p_lo
        const float dmv = dm ? dm[(size_t)t * T + u] : 1.f;
        if constexpr (kRowSum) {
          dsum[i] = fmaf(gg * dmv, p, dsum[i]);
        } else {
          pt = round_to<T_>(p * dmv);
          ds = round_to<T_>(p * (gg * dmv - s_D[r]));
        }
      }
      if constexpr (!kRowSum) {
        s[i][j] = pt;
        g[i][j] = ds;
      }
    }
  }
}

template <typename T_>
__device__ __forceinline__ void load_rows(float* dst, const T_* src, int row0, int rows, int T,
                                          int D, int ld, int tid) {
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const int t = row0 + r;
    dst[r * ld + c] = t < T ? to_f(src[(size_t)t * D + c]) : 0.f;
  }
}

template <typename T_>
__global__ void __launch_bounds__(NT) rel_attn_bwd_q(
    const T_* __restrict__ q, const T_* __restrict__ k, const T_* __restrict__ v,
    const T_* __restrict__ rel_k, const T_* __restrict__ rel_v,
    const float* __restrict__ kmask, const float* __restrict__ dmask,
    const T_* __restrict__ out, const T_* __restrict__ dout,
    const float* __restrict__ lse, T_* __restrict__ dq, float* __restrict__ dvec,
    float* __restrict__ band, float* __restrict__ drel_part, int T, int D, int window,
    int causal, int skip_upper) {
  constexpr bool kDFromOut = std::is_same<T_, float>::value;  // else the D sweep
  extern __shared__ float sm[];
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int ld = D + 1;
  const int ldp = BK + 1;
  float* sq = sm;                  // [BQ][ld]
  float* sdo = sq + BQ * ld;       // [BQ][ld]
  float* sk = sdo + BQ * ld;       // [BK][ld]
  float* sv = sk + BK * ld;        // [BK][ld]
  float* sds = sv + BK * ld;       // [BQ][ldp]
  float* srk = sds + BQ * ldp;     // [win][D]
  float* srv = srk + win * D;      // [win][D]
  float* srl = srv + win * D;      // [BQ][win] q . rel_k
  float* sgr = srl + BQ * win;     // [BQ][win] dout . rel_v
  float* sdsb = sgr + BQ * win;    // [BQ][win] band of ds
  float* sptb = sdsb + BQ * win;   // [BQ][win] band of pt
  float* s_lse = sptb + BQ * win;  // [BQ]
  float* s_D = s_lse + BQ;         // [BQ]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t base = (size_t)bh * T * D;
  const float* km = kmask ? kmask + (size_t)bh * T : nullptr;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;

  load_rows(sq, q + base, q0, BQ, T, D, ld, tid);
  load_rows(sdo, dout + base, q0, BQ, T, D, ld, tid);
  for (int i = tid; i < win * D; i += NT) {
    srk[i] = to_f(rel_k[i]);
    srv[i] = to_f(rel_v[i]);
  }
  for (int i = tid; i < BQ * win; i += NT) sdsb[i] = sptb[i] = 0.f;
  {  // lse per row and, in fp32, D = dout . out: 8 threads a row
    const int r = tid >> 3, l8 = tid & 7;
    const int t = q0 + r;
    float a = 0.f;
    if (kDFromOut && t < T)
      for (int c = l8; c < D; c += 8)
        a = fmaf(to_f(dout[base + (size_t)t * D + c]), to_f(out[base + (size_t)t * D + c]), a);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (l8 == 0) {
      s_lse[r] = t < T ? lse[(size_t)bh * T + t] : 0.f;
      if (kDFromOut) {
        s_D[r] = a;
        if (t < T) dvec[(size_t)bh * T + t] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * win; i += NT) {
    const int r = i / win, o = i - r * win;
    float a = 0.f, b = 0.f;
    for (int c = 0; c < D; ++c) {
      a = fmaf(sq[r * ld + c], srk[o * D + c], a);
      b = fmaf(sdo[r * ld + c], srv[o * D + c], b);
    }
    srl[i] = a;
    sgr[i] = b;
    const int t = q0 + r;
    if (t < T) {
      float* row = band + ((size_t)bh * T + t) * 2 * win;
      row[o] = a;
      row[win + o] = b;
    }
  }

  const int k_end = skip_upper ? min(T, q0 + BQ) : T;
  float s[2][4], g[2][4];
  if constexpr (!kDFromOut) {  // D = sum_u g p per row, before any ds
    float dsum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < k_end; k0 += BK) {
      __syncthreads();  // the previous tile is no longer read (first: srl and sgr are written)
      load_rows(sk, k + base, k0, BK, T, D, ld, tid);
      load_rows(sv, v + base, k0, BK, T, D, ld, tid);
      __syncthreads();
      tile_ds<T_, true>(sq, sdo, sk, sv, srl, sgr, s_lse, s_D, km, dm, q0, k0, T, D, ld, window,
                        win, causal, tx, ty, s, g, dsum);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // over the 16 threads of a row (one half-warp)
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], o);
      const int r = ty + 16 * i, t = q0 + r;
      if (tx == 0) {
        s_D[r] = dsum[i];
        if (t < T) dvec[(size_t)bh * T + t] = dsum[i];
      }
    }
  }

  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and ds are no longer read
    load_rows(sk, k + base, k0, BK, T, D, ld, tid);
    load_rows(sv, v + base, k0, BK, T, D, ld, tid);
    __syncthreads();
    tile_ds<T_, false>(sq, sdo, sk, sv, srl, sgr, s_lse, s_D, km, dm, q0, k0, T, D, ld, window,
                       win, causal, tx, ty, s, g, nullptr);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        sds[r * ldp + col] = g[i][j];
        const int off = k0 + col - (q0 + r);
        if (win && off >= -window && off <= window) {  // each (row, diagonal) once
          sdsb[r * win + off + window] = g[i][j];
          sptb[r * win + off + window] = s[i][j];
        }
      }
    }
    __syncthreads();
    for (int col = 0; col < BK; ++col) {
      const float d0 = sds[ty * ldp + col];
      const float d1 = sds[(ty + 16) * ldp + col];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float kk = sk[col * ld + c];
          acc[0][j] = fmaf(d0, kk, acc[0][j]);
          acc[1][j] = fmaf(d1, kk, acc[1][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= D) continue;
      float o = acc[i][j];
      for (int ow = 0; ow < win; ++ow) o = fmaf(sdsb[r * win + ow], srk[ow * D + c], o);
      dq[base + (size_t)t * D + c] = from_f<T_>(o);
    }
  }
  if (win) {
    float* part = drel_part + ((size_t)bh * gridDim.x + blockIdx.x) * 2 * win * D;
    for (int i = tid; i < win * D; i += NT) {
      const int o = i / D, c = i - o * D;
      float a = 0.f, b = 0.f;
      for (int r = 0; r < BQ; ++r) {  // rows past T hold zeros
        a = fmaf(sdsb[r * win + o], sq[r * ld + c], a);
        b = fmaf(sptb[r * win + o], sdo[r * ld + c], b);
      }
      part[i] = a;
      part[win * D + i] = b;
    }
  }
}

template <typename T_>
__global__ void __launch_bounds__(NT) rel_attn_bwd_kv(
    const T_* __restrict__ q, const T_* __restrict__ k, const T_* __restrict__ v,
    const float* __restrict__ kmask, const float* __restrict__ dmask,
    const T_* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const float* __restrict__ band, T_* __restrict__ dk,
    T_* __restrict__ dv, int T, int D, int window, int causal, int skip_upper) {
  extern __shared__ float sm[];
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int ld = D + 1;
  const int ldp = BK + 1;
  float* sk = sm;                  // [BK][ld]
  float* sv = sk + BK * ld;        // [BK][ld]
  float* sq = sv + BK * ld;        // [BQ][ld]
  float* sdo = sq + BQ * ld;       // [BQ][ld]
  float* spt = sdo + BQ * ld;      // [BQ][ldp]
  float* sds = spt + BQ * ldp;     // [BQ][ldp]
  float* srl = sds + BQ * ldp;     // [BQ][win]
  float* sgr = srl + BQ * win;     // [BQ][win]
  float* s_lse = sgr + BQ * win;   // [BQ]
  float* s_D = s_lse + BQ;         // [BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t base = (size_t)bh * T * D;
  const float* km = kmask ? kmask + (size_t)bh * T : nullptr;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;

  load_rows(sk, k + base, k0, BK, T, D, ld, tid);
  load_rows(sv, v + base, k0, BK, T, D, ld, tid);
  float adk[4][DJ], adv[4][DJ];  // key rows ty + 16 i, feature columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int q_begin = skip_upper ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < T; q0 += BQ) {
    __syncthreads();  // the previous tile is no longer read
    load_rows(sq, q + base, q0, BQ, T, D, ld, tid);
    load_rows(sdo, dout + base, q0, BQ, T, D, ld, tid);
    if (tid < BQ) {
      const int t = q0 + tid;
      s_lse[tid] = t < T ? lse[(size_t)bh * T + t] : 0.f;
      s_D[tid] = t < T ? dvec[(size_t)bh * T + t] : 0.f;
    }
    for (int i = tid; i < BQ * win; i += NT) {
      const int r = i / win, o = i - r * win;
      const int t = q0 + r;
      const float* row = band + ((size_t)bh * T + (t < T ? t : 0)) * 2 * win;
      srl[i] = t < T ? row[o] : 0.f;
      sgr[i] = t < T ? row[win + o] : 0.f;
    }
    __syncthreads();
    float s[2][4], g[2][4];
    tile_ds<T_, false>(sq, sdo, sk, sv, srl, sgr, s_lse, s_D, km, dm, q0, k0, T, D, ld, window,
                       win, causal, tx, ty, s, g, nullptr);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        spt[(ty + 16 * i) * ldp + tx + 16 * j] = s[i][j];
        sds[(ty + 16 * i) * ldp + tx + 16 * j] = g[i][j];
      }
    __syncthreads();
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = spt[r * ldp + ty + 16 * i];
        dsv[i] = sds[r * ldp + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float dov = sdo[r * ld + c];
          const float qv = sq[r * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pv[i], dov, adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = k0 + ty + 16 * i;
    if (u >= T) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= D) continue;
      dk[base + (size_t)u * D + c] = from_f<T_>(adk[i][j]);
      dv[base + (size_t)u * D + c] = from_f<T_>(adv[i][j]);
    }
  }
}

template <typename T_>
int launch(const void* q, const void* k, const void* v, const void* rel_k, const void* rel_v,
           const float* kmask, const float* dmask, const void* out, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* dvec, float* band,
           float* drel_part, int bh, int t, int d, int window, int causal, cudaStream_t s) {
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int ld = d + 1, ldp = BK + 1;
  const int skip_upper = causal && kmask == nullptr;
  const size_t smem_q = sizeof(float) * (2 * (size_t)BQ * ld + 2 * (size_t)BK * ld +
                                         (size_t)BQ * ldp + 2 * (size_t)win * d +
                                         4 * (size_t)BQ * win + 2 * (size_t)BQ);
  const size_t smem_kv = sizeof(float) * (2 * (size_t)BK * ld + 2 * (size_t)BQ * ld +
                                          2 * (size_t)BQ * ldp + 2 * (size_t)BQ * win +
                                          2 * (size_t)BQ);
  cudaError_t e = cudaFuncSetAttribute(rel_attn_bwd_q<T_>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(rel_attn_bwd_kv<T_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  rel_attn_bwd_q<T_><<<dim3((t + BQ - 1) / BQ, bh), NT, smem_q, s>>>(
      (const T_*)q, (const T_*)k, (const T_*)v, (const T_*)rel_k, (const T_*)rel_v, kmask, dmask,
      (const T_*)out, (const T_*)dout, lse, (T_*)dq, dvec, band, drel_part, t, d, window, causal,
      skip_upper);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rel_attn_bwd_kv<T_><<<dim3((t + BK - 1) / BK, bh), NT, smem_kv, s>>>(
      (const T_*)q, (const T_*)k, (const T_*)v, kmask, dmask, (const T_*)dout, lse, dvec, band,
      (T_*)dk, (T_*)dv, t, d, window, causal, skip_upper);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 = 0: q, k, v, rel_k, rel_v, out, dout, dq, dk and dv are float; 1:
// __nv_bfloat16 (out is then not read: D comes from the key sweep). Scratch
// from the caller: dvec [bh * t], band [bh * t * 2 (2w+1)] and drel_part
// [ceil(t / 32) * bh * 2 * (2w+1) * d] (both null without a window), fp32.
extern "C" int sovits_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* rel_k, const void* rel_v,
    const float* kmask, const float* dmask, const void* out, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* dvec, float* band,
    float* drel_part, int bh, int t, int d, int window, int causal, int bf16, void* stream) {
  if (d < 1 || d > MAXD || t < 1 || bh < 1) return (int)cudaErrorInvalidValue;
  if (window >= 0 && (!rel_k || !rel_v || !band || !drel_part)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, rel_k, rel_v, kmask, dmask, out, dout, lse, dq, dk, dv,
                                 dvec, band, drel_part, bh, t, d, window, causal, s);
  return launch<float>(q, k, v, rel_k, rel_v, kmask, dmask, out, dout, lse, dq, dk, dv, dvec,
                       band, drel_part, bh, t, d, window, causal, s);
}

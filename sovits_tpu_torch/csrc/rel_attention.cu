// Fused relative-position self-attention, forward, fp32 or bf16 in and out.
//
// Replaces the TPU kernel sovits_tpu/ops/attention.py:_make_fused.fwd_pair
// (Pallas body _fwd_kernel). Same semantics on [BH, T, D] with q pre-scaled
// by 1/sqrt(D):
//   s[t, u]  = q[t] . k[u] + (|u - t| <= w ? q[t] . rel_k[u - t + w] : 0)
//   s[t, u]  = -1e4 where causal and u > t, or where key u is masked
//              (a replacement, not -inf: a fully masked row stays uniform)
//   p        = softmax_u(s)                       (fp32)
//   pt       = p * dm  (dm: an optional [BH, T, T] dropout mask of
//              keep/(1-rate) values, drawn by the caller)
//   out[t]   = sum_u pt[t, u] v[u] + sum_o pt[t, t + o - w] rel_v[o]
//   lse[t]   = log sum_u exp(s[t, u])   (optional [BH, T] output)
// The TPU kernel stores p [BH, T, T] for its backward; this one stores the
// log-sum-exp per row instead, from which rel_attention_bwd.cu recomputes
// p = exp(s - lse) exactly as the TPU kernel stored it, masked rows included.
// With neither mask nor lse pointer (inference) nothing of either is touched.
//
// bf16 (the JAX package's bf16 serving path): q, k, v, rel_k, rel_v and out
// are bf16; the masks and lse stay fp32. Values are widened to fp32 as they
// are staged, so scores, band, softmax and every sum are fp32, and the
// output is rounded to bf16 once. The TPU kernel rounds p = softmax(s) to
// bf16 before p . v and the band sums; this kernel's online softmax never
// holds p, so it rounds the unnormalised exp(s - running max) that stands in
// for it instead. Both roundings carry the same relative error (2^-9), and
// the row sum takes the unrounded values, as the TPU kernel's does.
// The TPU kernel holds the whole [T, T] score matrix of one (batch, head)
// on chip, which caps T at 1024. Here one block owns BQ query rows of one
// (batch, head) and streams the keys in BK-row tiles with an online softmax
// (running max and sum, rescaling the partial output), so any T runs.
//
// What bounds it on an H100: the inference shapes are small (ContentEncoder
// T = 128..8192 frames, BH = 2 per clip, D = 96), so the grid has only
// T/BQ * BH blocks and the kernel is latency- and occupancy-bound long
// before the fp32 FMA pipes or HBM are busy. All tiles live in shared
// memory (about 80 KB at D = 96); the products run as fp32 FMA loops from
// shared memory, with the row strides padded by one word so the two rows a
// warp reads fall in different banks. Tensor cores (wgmma) and TMA are left
// to later work.
//
// Band handling: q . rel_k[o] is computed once per query row as a
// [BQ, 2w+1] table and added only where |u - t| <= w. The value band
// sum_o p~[t, t + o - w] rel_v[o] is accumulated from the unnormalised
// probabilities under the same rescaling as the output and divided by the
// row sum at the end. Causal key tiles above the diagonal are not skipped:
// with a key mask a row can be fully masked, and its uniform row then covers
// those keys too, so computing them keeps every case exact.
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 64;   // keys per streamed tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int MAXD = 128;
constexpr int DJ = MAXD / 16;  // output columns per thread at most
constexpr float NEG = -1e4f;   // the reference's masking constant

template <typename T_>
__global__ void __launch_bounds__(NT) rel_attn_fwd(
    const T_* __restrict__ q, const T_* __restrict__ k,
    const T_* __restrict__ v, const T_* __restrict__ rel_k,
    const T_* __restrict__ rel_v, const float* __restrict__ kmask,
    const float* __restrict__ dmask, T_* __restrict__ out, float* __restrict__ lse,
    int T, int D, int window, int causal) {
  extern __shared__ float sm[];
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int ld = D + 1;
  const int ldp = BK + 1;
  float* sq = sm;              // [BQ][ld]
  float* sk = sq + BQ * ld;    // [BK][ld]
  float* sv = sk + BK * ld;    // [BK][ld]
  float* sp = sv + BK * ld;    // [BQ][ldp] scores, then probabilities
  float* srk = sp + BQ * ldp;  // [win][D]
  float* srv = srk + win * D;  // [win][D]
  float* srl = srv + win * D;  // [BQ][win] q . rel_k
  float* sbv = srl + BQ * win; // [BQ][win] value-band weights (unnormalised)
  float* s_m = sbv + BQ * win; // [BQ] running max
  float* s_l = s_m + BQ;       // [BQ] running sum
  float* s_c = s_l + BQ;       // [BQ] rescale factor of the current tile

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t base = (size_t)bh * T * D;
  const float* km = kmask ? kmask + (size_t)bh * T : nullptr;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    sq[r * ld + c] = t < T ? to_f(q[base + (size_t)t * D + c]) : 0.f;
  }
  for (int i = tid; i < win * D; i += NT) {
    srk[i] = to_f(rel_k[i]);
    srv[i] = to_f(rel_v[i]);
  }
  for (int i = tid; i < BQ; i += NT) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
  }
  for (int i = tid; i < BQ * win; i += NT) sbv[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < BQ * win; i += NT) {
    const int r = i / win, o = i - r * win;
    float a = 0.f;
    for (int c = 0; c < D; ++c) a = fmaf(sq[r * ld + c], srk[o * D + c], a);
    srl[i] = a;
  }

  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i - r * D;
      const int u = k0 + r;
      const bool in = u < T;
      sk[r * ld + c] = in ? to_f(k[base + (size_t)u * D + c]) : 0.f;
      sv[r * ld + c] = in ? to_f(v[base + (size_t)u * D + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty, ty + 16; columns tx + 16 j
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float a0 = sq[ty * ld + c];
      const float a1 = sq[(ty + 16) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = sk[(tx + 16 * j) * ld + c];
        s[0][j] = fmaf(a0, b, s[0][j]);
        s[1][j] = fmaf(a1, b, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const int t = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int u = k0 + col;
        float x = s[i][j];
        if (u >= T) {
          x = -INFINITY;  // past the sequence: no key at all
        } else {
          const int off = u - t;
          if (win && off >= -window && off <= window) x += srl[r * win + off + window];
          if (causal && off > 0) x = NEG;
          if (km && !(km[u] > 0.f)) x = NEG;
        }
        sp[r * ldp + col] = x;
      }
    }
    __syncthreads();

    // online softmax: 8 threads per row. The row sum takes p; what is kept
    // for p . v and the value band is p * dm (the TPU kernel's "store p,
    // then use p * dm").
    {
      const int r = tid >> 3;
      const int l8 = tid & 7;
      const int t = q0 + r;
      const float* dmr = (dm && t < T) ? dm + (size_t)t * T : nullptr;
      float mx = -INFINITY;
      for (int c = l8; c < BK; c += 8) mx = fmaxf(mx, sp[r * ldp + c]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a key
      float sum = 0.f;
      for (int c = l8; c < BK; c += 8) {
        const float e = expf(sp[r * ldp + c] - m_new);
        sum += e;
        const float er = round_to<T_>(e);  // p in the input type (exact for fp32)
        if (dm) {
          const int u = k0 + c;
          sp[r * ldp + c] = (dmr && u < T) ? er * dmr[u] : 0.f;
        } else {
          sp[r * ldp + c] = er;
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (l8 == 0) {
        const float sc = expf(m_old - m_new);  // 0 on the first tile
        s_m[r] = m_new;
        s_l[r] = s_l[r] * sc + sum;
        s_c[r] = sc;
      }
    }
    __syncthreads();

    if (win && tid < BQ) {
      const int r = tid;
      const int t = q0 + r;
      const float sc = s_c[r];
      for (int o = 0; o < win; ++o) {
        const int u = t + o - window;
        float pv = 0.f;
        if (u >= k0 && u < k0 + BK && u < T && u >= 0) pv = sp[r * ldp + (u - k0)];
        sbv[r * win + o] = sbv[r * win + o] * sc + pv;
      }
    }
    const float c0 = s_c[ty];
    const float c1 = s_c[ty + 16];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      acc[0][j] *= c0;
      acc[1][j] *= c1;
    }
    for (int c = 0; c < BK; ++c) {
      const float p0 = sp[ty * ldp + c];
      const float p1 = sp[(ty + 16) * ldp + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) {
          const float vv = sv[c * ld + col];
          acc[0][j] = fmaf(p0, vv, acc[0][j]);
          acc[1][j] = fmaf(p1, vv, acc[1][j]);
        }
      }
    }
  }
  __syncthreads();

  if (lse && tid < BQ && q0 + tid < T) lse[(size_t)bh * T + q0 + tid] = s_m[tid] + logf(s_l[tid]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t >= T) continue;
    const float inv_l = 1.f / s_l[r];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col >= D) continue;
      float o = acc[i][j];
      for (int ow = 0; ow < win; ++ow) o = fmaf(sbv[r * win + ow], srv[ow * D + col], o);
      out[base + (size_t)t * D + col] = from_f<T_>(o * inv_l);
    }
  }
}

template <typename T_>
int launch(const void* q, const void* k, const void* v, const void* rel_k, const void* rel_v,
           const float* kmask, const float* dmask, void* out, float* lse, int bh, int t, int d,
           int window, int causal, cudaStream_t stream) {
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int ld = d + 1;
  const size_t floats = (size_t)BQ * ld + 2 * (size_t)BK * ld + (size_t)BQ * (BK + 1) +
                        2 * (size_t)win * d + 2 * (size_t)BQ * win + 3 * (size_t)BQ;
  const size_t smem = floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rel_attn_fwd<T_>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + BQ - 1) / BQ, bh);
  rel_attn_fwd<T_><<<grid, NT, smem, stream>>>(
      (const T_*)q, (const T_*)k, (const T_*)v, (const T_*)rel_k, (const T_*)rel_v, kmask, dmask,
      (T_*)out, lse, t, d, window, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 = 0: q, k, v, rel_k, rel_v and out are float; 1: __nv_bfloat16.
extern "C" int sovits_rel_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* rel_k, const void* rel_v,
                                        const float* kmask, const float* dmask, void* out,
                                        float* lse, int bh, int t, int d, int window,
                                        int causal, int bf16, void* stream) {
  if (d < 1 || d > MAXD || t < 1 || bh < 1) return (int)cudaErrorInvalidValue;
  if (window >= 0 && (rel_k == nullptr || rel_v == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, rel_k, rel_v, kmask, dmask, out, lse, bh, t, d, window,
                                 causal, s);
  return launch<float>(q, k, v, rel_k, rel_v, kmask, dmask, out, lse, bh, t, d, window, causal, s);
}

// Fused relative-position self-attention, forward only, fp32 in and out.
//
// Replaces the TPU kernel sovits_tpu/ops/attention.py:_make_fused.fwd_pair
// (Pallas body _fwd_kernel). Same semantics on [BH, T, D] with q pre-scaled
// by 1/sqrt(D):
//   s[t, u]  = q[t] . k[u] + (|u - t| <= w ? q[t] . rel_k[u - t + w] : 0)
//   s[t, u]  = -1e4 where causal and u > t, or where key u is masked
//              (a replacement, not -inf: a fully masked row stays uniform)
//   p        = softmax_u(s)                       (fp32)
//   out[t]   = sum_u p[t, u] v[u] + sum_o p[t, t + o - w] rel_v[o]
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 64;   // keys per streamed tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int MAXD = 128;
constexpr int DJ = MAXD / 16;  // output columns per thread at most
constexpr float NEG = -1e4f;   // the reference's masking constant

__global__ void __launch_bounds__(NT) rel_attn_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ rel_k,
    const float* __restrict__ rel_v, const float* __restrict__ kmask,
    float* __restrict__ out, int T, int D, int window, int causal) {
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

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    sq[r * ld + c] = t < T ? q[base + (size_t)t * D + c] : 0.f;
  }
  for (int i = tid; i < win * D; i += NT) {
    srk[i] = rel_k[i];
    srv[i] = rel_v[i];
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
      sk[r * ld + c] = in ? k[base + (size_t)u * D + c] : 0.f;
      sv[r * ld + c] = in ? v[base + (size_t)u * D + c] : 0.f;
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

    // online softmax: 8 threads per row
    {
      const int r = tid >> 3;
      const int l8 = tid & 7;
      float mx = -INFINITY;
      for (int c = l8; c < BK; c += 8) mx = fmaxf(mx, sp[r * ldp + c]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a key
      float sum = 0.f;
      for (int c = l8; c < BK; c += 8) {
        const float e = expf(sp[r * ldp + c] - m_new);
        sp[r * ldp + c] = e;
        sum += e;
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
      out[base + (size_t)t * D + col] = o * inv_l;
    }
  }
}

}  // namespace

extern "C" int sovits_rel_attention_fwd(const float* q, const float* k, const float* v,
                                        const float* rel_k, const float* rel_v,
                                        const float* kmask, float* out, int bh, int t,
                                        int d, int window, int causal, void* stream) {
  if (d < 1 || d > MAXD || t < 1 || bh < 1) return (int)cudaErrorInvalidValue;
  if (window >= 0 && (rel_k == nullptr || rel_v == nullptr)) return (int)cudaErrorInvalidValue;
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int ld = d + 1;
  const size_t floats = (size_t)BQ * ld + 2 * (size_t)BK * ld + (size_t)BQ * (BK + 1) +
                        2 * (size_t)win * d + 2 * (size_t)BQ * win + 3 * (size_t)BQ;
  const size_t smem = floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rel_attn_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + BQ - 1) / BQ, bh);
  rel_attn_fwd<<<grid, NT, smem, (cudaStream_t)stream>>>(q, k, v, rel_k, rel_v, kmask, out, t,
                                                         d, window, causal);
  return (int)cudaGetLastError();
}

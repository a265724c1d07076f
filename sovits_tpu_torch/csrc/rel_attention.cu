// Fused relative-position self-attention, forward, fp32 or bf16 in and out,
// on the H100's tensor cores (mma.sync).
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
// The TPU kernel stores p [BH, T, T] for its backward and holds the whole
// [T, T] of one (batch, head) on chip (T <= 1024); this one streams the keys
// with an online softmax (any T) and stores the log-sum-exp per row, from
// which rel_attention_bwd.cu recomputes p = exp(s - lse), masked rows too.
//
// bf16: q, k, v, rel_k, rel_v and out are bf16; masks and lse fp32. The
// products run as mma.sync.m16n8k16 bf16 with fp32 accumulation (a product
// of two bf16 values is exact in fp32), so scores, band, softmax and sums are
// fp32. The TPU kernel rounds p = softmax(s) to bf16 before p . v and the band
// sums; the online softmax never holds p, so it rounds the unnormalised
// exp(s - running max) instead (the same relative error, 2^-9), and the row
// sum takes the unrounded values, as the TPU kernel's does. p . dm is rounded
// to bf16 again as the A operand of p . v (the plain version rounds pt too).
// fp32: 3xTF32 on mma.sync.m16n8k8.tf32 (as CUTLASS keeps fp32 accuracy on
// tensor cores): each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), and q . k is summed as lo.hi + hi.lo + hi.hi; p . v splits
// each operand in three and takes six products (below), so that a row with
// one key gets fp32's rounded p v. The tensor cores do not round their own
// sums to nearest, so each 8-wide step of the products is summed from zero
// and added to its total in fp32, rounded to nearest: the backward
// (rel_attention_bwd.cu) recomputes p from this LSE and takes dout . out
// with fp32 FMA, and an error that grew with D or T would show in its
// gradients.
//
// What bounds it on an H100: the serving shapes are small (BH 2 per clip,
// T 128..2048, D 96; 0.8 GFLOP at T 1024), so the kernel is bound by latency
// and by how much of the card it fills, long before the tensor cores or HBM
// are busy. The design, against the four limits of the FMA kernel it
// replaces:
//  1. Tensor cores. FlashAttention-2's warp tiling: a warp owns 16 query rows;
//     S = Q.K^T runs over D zero-padded to DP (32, 64, 96 or 128); the S
//     accumulators become P's A fragments in registers (bf16: two m16n8 C
//     tiles are one m16n8k16 A tile; fp32: the key order inside each 8-key
//     step is permuted so that C and tf32-A layouts agree, and the V rows
//     read for B follow the same order); V goes in through ldmatrix.trans
//     (bf16) or two conflict-free loads (fp32); the row max and sum are
//     reduced over the 4 threads of a quad with __shfl_xor_sync.
//  2. Filling the card. A block owns only 16 query rows; its 4 warps split
//     the key tiles between them (tile i to warp i mod 4), each with its own
//     running max, sum and output, and merge them (max, sum, output, band
//     weights) in shared memory at the end; the LSE is written after the
//     merge. BH 2, T 1024 launches 128 blocks (512 warps); BH 12, T 800
//     launches 600 blocks (2400 warps), two blocks an SM at D = 96.
//  3. Causal tiles above the diagonal are skipped when there is no key mask:
//     each row keeps its diagonal key, so exp(-1e4 - max) is 0 in fp32 for
//     every key above it (the same argument as rel_attention_bwd.cu). With a
//     key mask they are computed: a fully masked row is uniform over all T.
//  4. Overlap. Each warp double-buffers its K/V tiles with cp.async (16-byte
//     copies, zero-filled past T), so the next tile loads while this one
//     computes; a warp waits only for itself (__syncwarp), the block syncs
//     only around the start and the merge. Rows whose width is not a whole
//     number of 16-byte chunks (or unaligned pointers) load element by
//     element instead, into the same tiles.
// The band: q . rel_k[o] is an fp32 [16, 2w+1] table per block, added only
// on key tiles that meet [q0 - w, q0 + 15 + w]. The value band's weights
// pt[t, t + o - w] are written by the thread that holds that P entry (each
// entry has one owner), with the running max they were taken under; the
// merge rescales them to the final max and sum. Past T a score is -inf.
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int QR = 16;       // query rows per block (one mma row tile)
constexpr int NW = 4;        // warps per block; each streams every 4th key tile
constexpr int NT = 32 * NW;  // threads per block
constexpr int MAXD = 128;
constexpr float NEG = -1e4f;  // the reference's masking constant

// Per-type tiling: keys per tile and row padding (elements) of the K and V
// tiles, chosen so that the fragment loads hit 32 different banks and rows
// stay 16-byte aligned for cp.async and ldmatrix.
template <typename T_>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 32, PADK = 8, PADV = 8;
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16, PADK = 8, PADV = 4;
};

template <typename T_, int DP>
struct Layout {
  static constexpr int BK = Cfg<T_>::BK;
  static constexpr int LDK = DP + Cfg<T_>::PADK;  // q and k rows
  static constexpr int LDV = DP + Cfg<T_>::PADV;
  static constexpr size_t Q_BYTES = (size_t)QR * LDK * sizeof(T_);
  static constexpr size_t STAGE = (size_t)BK * (LDK + LDV) * sizeof(T_);  // one K + V tile
  static constexpr size_t WARP = 2 * STAGE;                             // double-buffered
  static_assert(WARP >= (size_t)QR * (DP + 2) * sizeof(float), "merge area fits a warp's tiles");
  static size_t bytes(int win) {
    return Q_BYTES + NW * WARP + (3 * (size_t)QR * win + (NW + 2) * (size_t)QR) * sizeof(float);
  }
};

// x = hi + lo + rest exactly: rest = x - hi - lo has at most 2 significant
// bits, so it is a tf32 value as it is
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo, uint32_t& rest) {
  split(x, hi, lo);
  rest = __float_as_uint(x - __uint_as_float(hi) - __uint_as_float(lo));
}
// c += p . v with p and v each exact in three tf32 parts and every partial
// product above 2^-33 |p v| (hi.hi, hi.lo, lo.hi, lo.lo, hi.rest, rest.hi):
// the sum of one product is fp32's rounded p v, as with fp32 FMA. The
// backward takes dout . out against its own dout . v: on a row with one key
// (p = 1, or the dropout scale) they must agree as closely as fp32 FMA makes
// them, or ds = p (g - dout . out) does not cancel. The small terms and hi.hi are
// summed apart from zero (the tensor cores' sums are not rounded to nearest)
// and added to c in fp32.
__device__ __forceinline__ void mma_pv_tf32(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                            const uint32_t ar[4], float b0, float b1) {
  uint32_t bh0, bl0, br0, bh1, bl1, br1;
  split3(b0, bh0, bl0, br0);
  split3(b1, bh1, bl1, br1);
  float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(small, ar, bh0, bh1);
  mma_tf32(small, ah, br0, br1);
  mma_tf32(small, al, bl0, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += small[e] + big[e];
}

// One warp's K and V tile: keys k0 .. k0 + BK - 1, zero past T.
template <typename T_, int DP>
__device__ __forceinline__ void load_kv(T_* sk, T_* sv, const T_* __restrict__ k,
                                        const T_* __restrict__ v, size_t base, int k0, int T, int D,
                                        bool vec, int lane) {
  using L = Layout<T_, DP>;
  if (vec) {
    constexpr int EPC = 16 / sizeof(T_);  // elements per 16-byte chunk
    const int cpr = D / EPC;
    for (int i = lane; i < L::BK * cpr; i += 32) {
      const int r = i / cpr, c = (i - r * cpr) * EPC;
      const int u = k0 + r;
      const bool in = u < T;
      const size_t off = base + (size_t)(in ? u : 0) * D + c;
      cp_async16(sk + r * L::LDK + c, k + off, in);
      cp_async16(sv + r * L::LDV + c, v + off, in);
    }
  } else {
    const T_ zero = from_f<T_>(0.f);
    for (int i = lane; i < L::BK * D; i += 32) {
      const int r = i / D, c = i - r * D;
      const int u = k0 + r;
      const bool in = u < T;
      sk[r * L::LDK + c] = in ? k[base + (size_t)u * D + c] : zero;
      sv[r * L::LDV + c] = in ? v[base + (size_t)u * D + c] : zero;
    }
  }
}

template <typename T_, int DP>
__global__ void __launch_bounds__(NT) rel_attn_fwd(
    const T_* __restrict__ q, const T_* __restrict__ k, const T_* __restrict__ v,
    const T_* __restrict__ rel_k, const T_* __restrict__ rel_v, const float* __restrict__ kmask,
    const float* __restrict__ dmask, T_* __restrict__ out, float* __restrict__ lse, int T, int D,
    int window, int causal, int vec) {
  using L = Layout<T_, DP>;
  constexpr bool BF16 = sizeof(T_) == 2;
  constexpr int BK = L::BK, LDK = L::LDK, LDV = L::LDV;
  constexpr int NN = DP / 8;  // 8-wide output column tiles
  constexpr int NS = BK / 8;  // 8-key score column tiles

  extern __shared__ __align__(16) unsigned char smem[];
  T_* sq = reinterpret_cast<T_*>(smem);  // [QR][LDK]
  unsigned char* kv = smem + L::Q_BYTES;  // per warp: 2 x (K [BK][LDK], V [BK][LDV])
  const int win = window >= 0 ? 2 * window + 1 : 0;
  float* srl = reinterpret_cast<float*>(kv + NW * L::WARP);  // [QR][win] q . rel_k
  float* bwv = srl + QR * win;  // [QR][win] value-band weights (unnormalised)
  float* bwm = bwv + QR * win;  // [QR][win] the running max each was taken under
  float* ssc = bwm + QR * win;  // [NW][QR] each warp's output scale at the merge
  float* s_m = ssc + NW * QR;   // [QR] final max
  float* s_il = s_m + QR;       // [QR] 1 / final sum

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group, thread in group
  const int bh = blockIdx.y, q0 = blockIdx.x * QR;
  const size_t base = (size_t)bh * T * D;
  const float* km = kmask ? kmask + (size_t)bh * T : nullptr;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;
  const T_ zero = from_f<T_>(0.f);

  for (int i = tid; i < QR * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    const int t = q0 + r;
    sq[r * LDK + c] = (t < T && c < D) ? q[base + (size_t)t * D + c] : zero;
  }
  for (int i = tid; i < QR * win; i += NT) {
    bwv[i] = 0.f;
    bwm[i] = -INFINITY;
  }
  T_* my = reinterpret_cast<T_*>(kv + warp * L::WARP);
  if (D < DP) {  // pad columns: never loaded, read as zeros by the products
    const int pad = DP - D;
    for (int i = lane; i < 4 * BK * pad; i += 32) {
      const int c = D + i % pad, rr = i / pad;  // rr: stage, tensor, row
      const int st = rr / (2 * BK), isv = (rr / BK) & 1, r = rr % BK;
      T_* tile = my + st * BK * (LDK + LDV) + isv * BK * LDK;
      tile[r * (isv ? LDV : LDK) + c] = zero;
    }
  }
  __syncthreads();
  for (int i = tid; i < QR * win; i += NT) {
    const int r = i / win, o = i - r * win;
    float a = 0.f;
    for (int c = 0; c < D; ++c) a = fmaf(to_f(sq[r * LDK + c]), to_f(rel_k[o * D + c]), a);
    srl[i] = a;
  }

  uint32_t qf[BF16 ? DP / 16 : 1][4];  // bf16: Q's A fragments, held for the whole loop
  if constexpr (BF16) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldsm_x4(qf[kk], sq + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDK + kk * 16 + (lane >> 4) * 8);
  }
  __syncthreads();  // srl ready

  const int kend = (causal && !km) ? min(T, q0 + QR) : T;  // skip causal tiles above the diagonal
  const int ntiles = (kend + BK - 1) / BK;
  const int qlast = q0 + QR - 1;
  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows g, g + 8

  if (warp < ntiles) load_kv<T_, DP>(my, my + BK * LDK, k, v, base, warp * BK, T, D, vec, lane);
  cp_async_commit();
  for (int it = 0, tile = warp; tile < ntiles; ++it, tile += NW) {
    if (tile + NW < ntiles) {
      T_* nx = my + ((it + 1) & 1) * BK * (LDK + LDV);
      load_kv<T_, DP>(nx, nx + BK * LDK, k, v, base, (tile + NW) * BK, T, D, vec, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const T_* sk = my + (it & 1) * BK * (LDK + LDV);
    const T_* sv = sk + BK * LDK;
    const int k0 = tile * BK;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];  // keys 8j.. and 8(j+1).., d 16kk.. and 16kk + 8..
          ldsm_x4(b, sk + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LDK + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], qf[kk], b[0], b[1]);
          mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
        }
    } else {
      // tf32 A/B column t <-> d 2t, column t + 4 <-> d 2t + 1 inside each 8-wide step
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const float2 qa = *reinterpret_cast<const float2*>(sq + g * LDK + kk * 8 + 2 * tq);
        const float2 qb = *reinterpret_cast<const float2*>(sq + (g + 8) * LDK + kk * 8 + 2 * tq);
        uint32_t ah[4], al[4];
        split(qa.x, ah[0], al[0]);
        split(qb.x, ah[1], al[1]);
        split(qa.y, ah[2], al[2]);
        split(qb.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 kb = *reinterpret_cast<const float2*>(sk + (j * 8 + g) * LDK + kk * 8 + 2 * tq);
          mma_3xtf32_step(s[j], ah, al, kb.x, kb.y);  // rounded to nearest, step by step
        }
      }
    }

    // band, masks and the online softmax on the accumulators: thread holds
    // rows g (e = 0, 1) and g + 8 (e = 2, 3), keys k0 + 8j + 2tq + (e & 1)
    const bool band = win && k0 <= qlast + window && k0 + BK - 1 >= q0 - window;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), t = q0 + r;
        const int u = k0 + j * 8 + 2 * tq + (e & 1);
        float x = s[j][e];
        if (u >= T) {
          x = -INFINITY;  // past the sequence: no key at all
        } else {
          const int off = u - t;
          if (band && off >= -window && off <= window) x += srl[r * win + off + window];
          if (causal && off > 0) x = NEG;
          if (km && !(km[u] > 0.f)) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);  // finite: key k0 < T is in every tile
      sc[h] = expf(m_r[h] - m_new);              // 0 on the warp's first tile
      m_r[h] = m_new;
      l_r[h] *= sc[h];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = g + 8 * h, t = q0 + r;
        const int u = k0 + j * 8 + 2 * tq + (e & 1);
        const float ex = expf(s[j][e] - m_r[h]);
        l_r[h] += ex;  // the row sum takes p unrounded
        float p = round_to<T_>(ex);  // p in the input type (exact for fp32)
        if (dm) p = (t < T && u < T) ? p * dm[(size_t)t * T + u] : 0.f;
        s[j][e] = p;
        if (band && u < T) {
          const int off = u - t;
          if (off >= -window && off <= window) {  // each (row, diagonal) has one owner
            bwv[r * win + off + window] = p;
            bwm[r * win + off + window] = m_r[h];
          }
        }
      }

#pragma unroll
    for (int n = 0; n < NN; ++n) {
      acc[n][0] *= sc[0];
      acc[n][1] *= sc[0];
      acc[n][2] *= sc[1];
      acc[n][3] *= sc[1];
    }
    if constexpr (BF16) {
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        const uint32_t a[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]), pack_bf16(s[2 * i][2], s[2 * i][3]),
                               pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                               pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
        for (int mm = 0; mm < DP / 16; ++mm) {
          uint32_t b[4];  // keys 16i.. and 16i + 8.., d 16mm.. and 16mm + 8..
          ldsm_x4_t(b, sv + (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + mm * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * mm], a, b[0], b[1]);
          mma_bf16(acc[2 * mm + 1], a, b[2], b[3]);
        }
      }
    } else {
      // tf32 A column t <-> key 2t, t + 4 <-> key 2t + 1: the C layout as it is
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t ah[4], al[4], ar[4];
        split3(s[j][0], ah[0], al[0], ar[0]);
        split3(s[j][2], ah[1], al[1], ar[1]);
        split3(s[j][1], ah[2], al[2], ar[2]);
        split3(s[j][3], ah[3], al[3], ar[3]);
        const T_* v0 = sv + (j * 8 + 2 * tq) * LDV + g;
#pragma unroll
        for (int n = 0; n < NN; ++n) mma_pv_tf32(acc[n], ah, al, ar, v0[n * 8], v0[LDV + n * 8]);
      }
    }
    __syncwarp();  // this stage is read; the next iteration may refill it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  __syncthreads();  // every warp is done with its tiles: they hold the merge now
  float* mo = reinterpret_cast<float*>(kv + warp * L::WARP);  // [QR][DP], then m[QR], l[QR]
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    *reinterpret_cast<float2*>(mo + g * DP + n * 8 + 2 * tq) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(mo + (g + 8) * DP + n * 8 + 2 * tq) = make_float2(acc[n][2], acc[n][3]);
  }
  if (tq == 0) {
    mo[QR * DP + g] = m_r[0];
    mo[QR * DP + g + 8] = m_r[1];
    mo[QR * DP + QR + g] = l_r[0];
    mo[QR * DP + QR + g + 8] = l_r[1];
  }
  __syncthreads();
  if (tid < QR) {
    const int r = tid;
    float m = -INFINITY;
    for (int w = 0; w < NW; ++w)
      m = fmaxf(m, reinterpret_cast<const float*>(kv + w * L::WARP)[QR * DP + r]);
    float l = 0.f, e[NW];
    for (int w = 0; w < NW; ++w) {
      const float* mw = reinterpret_cast<const float*>(kv + w * L::WARP) + QR * DP;
      e[w] = expf(mw[r] - m);  // 0 for a warp that had no tile
      l = fmaf(mw[QR + r], e[w], l);
    }
    const float il = 1.f / l;
    for (int w = 0; w < NW; ++w) ssc[w * QR + r] = e[w] * il;
    s_m[r] = m;
    s_il[r] = il;
    if (lse && q0 + r < T) lse[(size_t)bh * T + q0 + r] = m + logf(l);
  }
  __syncthreads();
  for (int i = tid; i < QR * win; i += NT) {
    const int r = i / win;
    bwv[i] *= expf(bwm[i] - s_m[r]) * s_il[r];  // 0 where no key was
  }
  __syncthreads();
  for (int i = tid; i < QR * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    if (t >= T) continue;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      o = fmaf(reinterpret_cast<const float*>(kv + w * L::WARP)[r * DP + c], ssc[w * QR + r], o);
    for (int ow = 0; ow < win; ++ow) o = fmaf(bwv[r * win + ow], to_f(rel_v[ow * D + c]), o);
    out[base + (size_t)t * D + c] = from_f<T_>(o);
  }
}

template <typename T_, int DP>
int launch_dp(const void* q, const void* k, const void* v, const void* rel_k, const void* rel_v,
              const float* kmask, const float* dmask, void* out, float* lse, int bh, int t, int d,
              int window, int causal, cudaStream_t stream) {
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const size_t smem = Layout<T_, DP>::bytes(win);
  cudaError_t e = cudaFuncSetAttribute(rel_attn_fwd<T_, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // 16-byte cp.async needs whole 16-byte chunks per row and aligned tensors
  const int vec = (d * sizeof(T_)) % 16 == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  dim3 grid((t + QR - 1) / QR, bh);
  rel_attn_fwd<T_, DP><<<grid, NT, smem, stream>>>(
      (const T_*)q, (const T_*)k, (const T_*)v, (const T_*)rel_k, (const T_*)rel_v, kmask, dmask,
      (T_*)out, lse, t, d, window, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T_>
int launch(const void* q, const void* k, const void* v, const void* rel_k, const void* rel_v,
           const float* kmask, const float* dmask, void* out, float* lse, int bh, int t, int d,
           int window, int causal, cudaStream_t s) {
  // D is zero-padded to the next of 32, 64, 96, 128
  if (d <= 32)
    return launch_dp<T_, 32>(q, k, v, rel_k, rel_v, kmask, dmask, out, lse, bh, t, d, window, causal, s);
  if (d <= 64)
    return launch_dp<T_, 64>(q, k, v, rel_k, rel_v, kmask, dmask, out, lse, bh, t, d, window, causal, s);
  if (d <= 96)
    return launch_dp<T_, 96>(q, k, v, rel_k, rel_v, kmask, dmask, out, lse, bh, t, d, window, causal, s);
  return launch_dp<T_, MAXD>(q, k, v, rel_k, rel_v, kmask, dmask, out, lse, bh, t, d, window, causal, s);
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

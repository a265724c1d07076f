// One NSF-HiFiGAN upsample stage's ResBlock1 trio, fused, fp32 or bf16 in and out.
//
// Replaces the TPU kernel sovits_tpu/ops/fused_stage.py:
// fused_resblock_trio_folded (Pallas body kernel_fn). It computes
//   out = mean_j ResBlock1_j(x),   j over the kernel sizes (3, 7, 11),
// where each ResBlock1_j runs, for each dilation d in (1, 3, 5):
//   x = x + conv_k(lrelu(conv_{k,d}(lrelu(x))))     lrelu slope 0.1,
// 18 biased 'same' convs in all, with torch's zero padding at the clip
// edges: rows outside [0, T) are zero at the input of every conv.
//
// Layout: x and out are [B, T, C] (channels last); the weights of the 18
// convs are packed in chain order as [k, C_in, C_out] each; biases [18, C]
// fp32. The
// TPU kernel time-folds to [T/P, P*C] with P*C = 128 to fill its matrix
// unit; that is TPU layout work and has no counterpart here.
//
// Block structure (both types): one block per (batch row, tile of TT output
// rows), TT and the window size from the wrapper's plan
// (ops/fused_stage.py::trio_plan), which this entry point checks and then
// trusts. The block runs the three chains one after another. For each chain
// it loads the tile plus that chain's own halo (12, 36 and 60 rows on each
// side for k = 3, 7, 11: the sum of the chain's six conv reaches) into
// shared memory, runs the six convs on chip -- the fp32 residual stream in
// one buffer, the inner activation in a second -- and adds the chain's
// centre rows into the output. Each conv computes only the rows the rest of
// the chain still reads, so the halo costs 6*TT + 2*sum(remaining reach)
// rows per chain, not 6*(TT + 2*halo). Intermediates never touch device
// memory; x is read once per chain and the output is written three times by
// the block that owns it. The mean over the chains is summed in an fp32
// scratch [B, T, C] (for fp32 the output itself).
//
// What bounds it on an H100: arithmetic. A 10 s clip needs about 0.43
// TFLOP across the four stages (C = 128, 64, 32, 16), plus the halo
// recompute (1.4-1.7x at C = 128, under 1.1x at C <= 32).
//
// Both types run the inner product on the tensor cores (mma.sync) with the
// same structure. 8 warps; each owns m16 row tiles
// (tile i of the conv's rows goes to warp row i mod WM, so shrinking convs
// keep every warp busy) across C / WN output channels, and keeps their fp32
// sums in registers for the whole conv. Per conv, the weights stream
// through shared memory in steps of a tap or part of one, as they are packed
// ([C_in][C_out] rows), double-buffered with cp.async: one barrier per step.
// The first conv of a pair builds its A fragments in registers from the
// fp32 residual (lrelu, then the type's rounding); its epilogue stores
// lrelu(y), the second conv's A operand. A tap's dilated shift is only
// another row base per lane. Rows past the conv's range in a tile are
// computed and never stored; their reads are clamped into the window.
//
// bf16 (the serving path): mma.sync.m16n8k16 bf16 with fp32 sums. The
// first conv's A: 8-byte reads of a column pair, row stride C + 8 words,
// free of bank conflicts at every shift; the inner activation is stored as
// bf16(lrelu(y)), the A operand as the TPU kernel's matrix unit would take
// it, and read with ldmatrix (row stride C + 8 elements), so it costs 2
// bytes a value: the window holds 242 rows at C = 128. B fragments by
// ldmatrix.trans from [C_in][C_out + 8] bf16 steps (a tap, half a tap at
// C = 128). Conv inputs are rounded to bf16 (weights bf16); sums, biases,
// the residual stream and the mean fp32; the output rounded to bf16 once:
// within 2e-2 x max|plain| of the plain fp32 arithmetic.
//
// fp32: 3xTF32 on mma.sync.m16n8k8.tf32, as K1 (rel_attention.cu) keeps
// fp32 accuracy on the tensor cores: A (after lrelu) and B are each split
// into hi = tf32(v) and lo = tf32(v - hi), and every 8-deep step sums
// lo.hi + hi.lo + hi.hi from zero, then adds that to its fp32 total: the
// tensor cores do not round their own sums to nearest, and a conv sums up
// to 11 x 128 products (summed straight into the total, the C = 128 stage
// of a 10 s clip came to 9.2e-6 max-abs on an H100, 74% of the fp32 bar;
// summed per step, 9.5e-7). Both windows are fp32 (row stride C + 8 words);
// inside each 8-deep step the input channels are permuted (logical k = tq
// and tq + 4 are channels 2tq and 2tq + 1) so that one 8-byte read gives a
// lane both of its A values of a row; B's two values per lane are 4-byte
// reads of rows 2tq and 2tq + 1 of [C_in][C_out + 4] fp32 steps (32 input
// channels, 16 at C = 16; row stride C + 4 words, conflict-free), split in
// registers once per 8-deep step and reused by every row tile. The window
// holds 182 rows at C = 128. One-pass TF32 would miss the fp32 bar (rtol
// 1e-4, atol 1e-5).
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int NT = 256;  // threads, 8 warps, in both instantiations
constexpr int NWARP = NT / 32;
constexpr int MAX_CHAINS = 3;
constexpr int MAX_PAIRS = 3;
constexpr int MAX_CONVS = 2 * MAX_CHAINS * MAX_PAIRS;
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may opt in to
constexpr float SLOPE = 0.1f;

struct Plan {
  int n_chains;
  int n_convs;
  int k[MAX_CHAINS];
  int n_pairs[MAX_CHAINS];
  int dil[MAX_CHAINS][MAX_PAIRS];
  int halo[MAX_CHAINS];
  long long w_off[MAX_CONVS];  // element offset of each conv's k * C * C weights
  int rows;                    // window rows a block holds
  int tt;                      // output rows per block
};

__device__ __forceinline__ float lrelu(float x) { return fmaxf(x, SLOPE * x); }

// c = a . b on a 16x8x8 tf32 tile, summed from zero
__device__ __forceinline__ void mma_tf32_from_zero(float c[4], const uint32_t a[4], uint32_t b0,
                                                   uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Tiling shared by both types: WN warps across the output channels, WM
// across the rows, MI m16 tiles per warp, so one conv covers PASS rows (the
// window's cap); weights staged KCH input channels per step, row stride LDW.
template <int C, typename E, int KCH_, int LDW_, int MI_>
struct Tiling {
  using T = E;  // x, weights and output
  static constexpr int CH = C;
  static constexpr int LDX = C + 8;  // fp32 residual row stride (words): 8-byte reads conflict-free
  static constexpr int KCH = KCH_;
  static constexpr int LDW = LDW_;
  static constexpr int NKC = C / KCH;  // steps per tap
  static constexpr int WN = C == 128 ? 2 : 1;
  static constexpr int WM = NWARP / WN;
  static constexpr int NN = C / WN / 8;  // n8 tiles per warp
  static constexpr int MI = MI_;
  static constexpr int PASS = WM * MI * 16;
  static constexpr int WBUF = KCH * LDW;  // one staged step (elements)
  static_assert(C % 16 == 0 && NN % 2 == 0 && C % KCH == 0, "tiling");
};

// bf16: the inner activation bf16 [rows][C + 8]; weight steps [KCH][C + 8] bf16
template <int C>
struct Bf16 : Tiling<C, __nv_bfloat16, (C < 64 ? C : 64), C + 8, (C >= 64 ? 4 : C == 32 ? 8 : 16)> {
  using A = __nv_bfloat16;
  static constexpr int LDA = C + 8;
  static size_t bytes(int rows) {
    return 2 * (size_t)Bf16::WBUF * 2 + (size_t)rows * (Bf16::LDX * 4 + LDA * 2);
  }
};

// fp32: the inner activation fp32 [rows][C + 8]; weight steps [KCH][C + 4] fp32
template <int C>
struct Fp32 : Tiling<C, float, (C < 32 ? C : 32), C + 4, (C >= 64 ? 3 : C == 32 ? 6 : 10)> {
  using A = float;
  static constexpr int LDA = C + 8;
  static size_t bytes(int rows) {
    return 2 * (size_t)Fp32::WBUF * 4 + (size_t)rows * (Fp32::LDX + LDA) * 4;
  }
};

// Step s of a conv's weights (tap s / NKC, input channels (s % NKC) * KCH
// on), [KCH][C_out] of the packed [k][C_in][C_out], into dst [KCH][LDW].
template <typename K>
__device__ __forceinline__ void issue_step(const typename K::T* __restrict__ w, int s,
                                           typename K::T* dst) {
  constexpr int C = K::CH;
  constexpr int EPP = 16 / sizeof(typename K::T);  // elements per 16-byte piece
  constexpr int PER_ROW = C / EPP;
  const int j = s / K::NKC, kc = s - j * K::NKC;
  const typename K::T* src = w + ((size_t)j * C + kc * K::KCH) * C;
  for (int i = threadIdx.x; i < K::KCH * PER_ROW; i += NT) {
    const int r = i / PER_ROW, p = i - r * PER_ROW;
    cp_async16(dst + r * K::LDW + p * EPP, src + (size_t)r * C + p * EPP, true);
  }
}

// The m16 row tiles of this warp inside [lo, hi): tile i of the conv's rows
// goes to warp row i mod WM, so the shrinking convs keep every warp busy.
template <typename K>
__device__ __forceinline__ int active_tiles(int wm, int lo, int hi) {
  int n = 0;
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi) n += lo + (wm + mi * K::WM) * 16 < hi;
  return n;
}

// The weight pipeline of one conv: before step s, wait for it and issue the
// next (step s + 1, or step 0 of w_next), then compute(step's weights, tap,
// first input channel). On entry step 0 of w is in flight into wsm[buf].
template <typename K, typename F>
__device__ __forceinline__ void stream_steps(typename K::T* wsm, int& buf,
                                             const typename K::T* __restrict__ w,
                                             const typename K::T* __restrict__ w_next, int k,
                                             bool active, F&& compute) {
  const int n_steps = k * K::NKC;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s is in wsm[buf] for all; everyone is done with wsm[buf ^ 1]
    if (s + 1 < n_steps)
      issue_step<K>(w, s + 1, wsm + (buf ^ 1) * K::WBUF);
    else if (w_next != nullptr)
      issue_step<K>(w_next, 0, wsm + (buf ^ 1) * K::WBUF);
    cp_async_commit();
    const typename K::T* wb = wsm + buf * K::WBUF;
    buf ^= 1;
    if (!active) continue;
    const int j = s / K::NKC;
    compute(wb, j, (s - j * K::NKC) * K::KCH);
  }
}

// The epilogue of one conv: y = sum + bias inside [0, T), 0 outside, for the
// rows of [lo, hi) this warp holds. FROM_X: xa = lrelu(y) (in xa's type);
// otherwise xr += y.
template <typename K, bool FROM_X>
__device__ __forceinline__ void epilogue(float (&acc)[K::MI][K::NN][4], float* xr,
                                         typename K::A* xa, const float* __restrict__ bias,
                                         int n_act, int wm, int n0, int lo, int hi, int g0, int T) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi) {
    if (mi >= n_act) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = lo + (wm + mi * K::WM) * 16 + g + 8 * hr;
      if (r >= hi) continue;
      const int gr = g0 + r;
      const bool inside = gr >= 0 && gr < T;
#pragma unroll
      for (int n = 0; n < K::NN; ++n) {
        const int c = n0 + n * 8 + 2 * tq;
        const float2 bb = *reinterpret_cast<const float2*>(bias + c);
        const float y0 = inside ? acc[mi][n][2 * hr] + bb.x : 0.f;
        const float y1 = inside ? acc[mi][n][2 * hr + 1] + bb.y : 0.f;
        if (FROM_X) {
          if constexpr (sizeof(typename K::A) == 2)
            *reinterpret_cast<uint32_t*>(xa + r * K::LDA + c) = pack_bf16(lrelu(y0), lrelu(y1));
          else
            *reinterpret_cast<float2*>(xa + r * K::LDA + c) = make_float2(lrelu(y0), lrelu(y1));
        } else {
          float2* p = reinterpret_cast<float2*>(xr + r * K::LDX + c);
          float2 o = *p;
          o.x += y0;
          o.y += y1;
          *p = o;
        }
      }
    }
  }
}

// One 'same' conv over window rows [lo, hi): y[r] = bias + sum_j
// lrelu(in[r + (j - half) d]) . w_j, rows outside [0, T) zero. FROM_X: in
// is the fp32 residual xr and lrelu(y) goes to xa; otherwise in is xa
// (lrelu already applied) and y is added into xr. bf16 inner product.
template <int C, bool FROM_X>
__device__ __forceinline__ void conv(float* xr, __nv_bfloat16* xa, __nv_bfloat16* wsm, int& buf,
                                          const __nv_bfloat16* __restrict__ w,
                                          const __nv_bfloat16* __restrict__ w_next,
                                          const float* __restrict__ bias, int k, int d, int lo,
                                          int hi, int g0, int T, int rows) {
  using K = Bf16<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % K::WN, wm = warp / K::WN;
  const int g = lane >> 2, tq = lane & 3;
  const int half = (k - 1) / 2;
  const int n0 = wn * (C / K::WN);  // first output channel of this warp
  const int n_act = active_tiles<K>(wm, lo, hi);
  float acc[K::MI][K::NN][4];
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi)
#pragma unroll
    for (int n = 0; n < K::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

  stream_steps<K>(wsm, buf, w, w_next, k, n_act > 0, [&](const __nv_bfloat16* wb, int j, int cin0) {
    const int shift = (j - half) * d;
#pragma unroll
    for (int kk = 0; kk < K::KCH / 16; ++kk) {
      uint32_t b[K::NN][2];
#pragma unroll
      for (int np = 0; np < K::NN / 2; ++np) {
        uint32_t r4[4];
        ldsm_x4_t(r4, wb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * K::LDW + n0 + np * 16 +
                          (lane >> 4) * 8);
        b[2 * np][0] = r4[0];
        b[2 * np][1] = r4[1];
        b[2 * np + 1][0] = r4[2];
        b[2 * np + 1][1] = r4[3];
      }
      const int cin = cin0 + kk * 16;
#pragma unroll
      for (int mi = 0; mi < K::MI; ++mi) {
        if (mi >= n_act) break;
        const int r0 = lo + (wm + mi * K::WM) * 16 + shift;
        uint32_t a[4];
        if (FROM_X) {
          const float* ra = xr + min(r0 + g, rows - 1) * K::LDX + cin + 2 * tq;
          const float* rb = xr + min(r0 + g + 8, rows - 1) * K::LDX + cin + 2 * tq;
          const float2 v0 = *reinterpret_cast<const float2*>(ra);
          const float2 v1 = *reinterpret_cast<const float2*>(rb);
          const float2 v2 = *reinterpret_cast<const float2*>(ra + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(rb + 8);
          a[0] = pack_bf16(lrelu(v0.x), lrelu(v0.y));
          a[1] = pack_bf16(lrelu(v1.x), lrelu(v1.y));
          a[2] = pack_bf16(lrelu(v2.x), lrelu(v2.y));
          a[3] = pack_bf16(lrelu(v3.x), lrelu(v3.y));
        } else {
          const int r = min(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, rows - 1);
          ldsm_x4(a, xa + r * K::LDA + cin + (lane >> 4) * 8);
        }
#pragma unroll
        for (int n = 0; n < K::NN; ++n) mma_bf16(acc[mi][n], a, b[n][0], b[n][1]);
      }
    }
  });
  epilogue<K, FROM_X>(acc, xr, xa, bias, n_act, wm, n0, lo, hi, g0, T);
}

// As above, 3xTF32: each 8-deep step's three products are summed from
// zero and added to the fp32 total.
template <int C, bool FROM_X>
__device__ __forceinline__ void conv(float* xr, float* xa, float* wsm, int& buf,
                                          const float* __restrict__ w, const float* __restrict__ w_next,
                                          const float* __restrict__ bias, int k, int d, int lo, int hi,
                                          int g0, int T, int rows) {
  using K = Fp32<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % K::WN, wm = warp / K::WN;
  const int g = lane >> 2, tq = lane & 3;
  const int half = (k - 1) / 2;
  const int n0 = wn * (C / K::WN);
  const int n_act = active_tiles<K>(wm, lo, hi);
  float acc[K::MI][K::NN][4];
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi)
#pragma unroll
    for (int n = 0; n < K::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  const float* in = FROM_X ? xr : xa;

  stream_steps<K>(wsm, buf, w, w_next, k, n_act > 0, [&](const float* wb, int j, int cin0) {
    const int shift = (j - half) * d;
#pragma unroll 1
    for (int kk = 0; kk < K::KCH / 8; ++kk) {  // not unrolled: its registers would spill at C >= 64
      // A, every row tile's: channels 2tq and 2tq + 1 of the step (logical k = tq, tq + 4)
      const int cin = cin0 + kk * 8 + 2 * tq;
      uint32_t ah[K::MI][4], al[K::MI][4];
#pragma unroll
      for (int mi = 0; mi < K::MI; ++mi) {
        if (mi >= n_act) break;
        const int r0 = lo + (wm + mi * K::WM) * 16 + shift;
        float2 v0 = *reinterpret_cast<const float2*>(in + min(r0 + g, rows - 1) * K::LDX + cin);
        float2 v1 = *reinterpret_cast<const float2*>(in + min(r0 + g + 8, rows - 1) * K::LDX + cin);
        if (FROM_X) {
          v0 = make_float2(lrelu(v0.x), lrelu(v0.y));
          v1 = make_float2(lrelu(v1.x), lrelu(v1.y));
        }
        split(v0.x, ah[mi][0], al[mi][0]);
        split(v1.x, ah[mi][1], al[mi][1]);
        split(v0.y, ah[mi][2], al[mi][2]);
        split(v1.y, ah[mi][3], al[mi][3]);
      }
      // B, one n8 tile at a time (the same channels, column n0 + 8n + g), split once for every row tile
#pragma unroll
      for (int n = 0; n < K::NN; ++n) {
        const float* bp = wb + (kk * 8 + 2 * tq) * K::LDW + n0 + n * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(bp[0], bh0, bl0);
        split(bp[K::LDW], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < K::MI; ++mi) {
          if (mi >= n_act) break;
          float t[4];
          mma_tf32_from_zero(t, al[mi], bh0, bh1);
          mma_tf32(t, ah[mi], bl0, bl1);
          mma_tf32(t, ah[mi], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] += t[e];
        }
      }
    }
  });
  epilogue<K, FROM_X>(acc, xr, xa, bias, n_act, wm, n0, lo, hi, g0, T);
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = pack_bf16(v.x, v.y);
  u.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// The block: the chains one after another, each over its own window; the
// mean summed in acc (fp32; for fp32 the output itself).
template <typename K>
__device__ __forceinline__ void trio_body(const typename K::T* __restrict__ x,
                                          const typename K::T* __restrict__ w,
                                          const float* __restrict__ bias, typename K::T* out,
                                          float* acc, int T, const Plan& plan) {
  using E = typename K::T;
  constexpr int C = K::CH;
  constexpr int Q = C / 4;  // 4-wide column groups
  extern __shared__ __align__(16) unsigned char smraw[];
  E* wsm = reinterpret_cast<E*>(smraw);                                   // two weight steps [KCH][LDW]
  float* xr = reinterpret_cast<float*>(wsm + 2 * K::WBUF);                // residual stream [rows][LDX]
  typename K::A* xa = reinterpret_cast<typename K::A*>(xr + plan.rows * K::LDX);  // lrelu(inner) [rows][LDA]

  const int TT = plan.tt;
  const int t0 = blockIdx.x * TT;
  const E* xb = x + (size_t)blockIdx.y * T * C;
  E* ob = out + (size_t)blockIdx.y * T * C;
  float* ab = acc + (size_t)blockIdx.y * T * C;
  int buf = 0;
  issue_step<K>(w + plan.w_off[0], 0, wsm);
  cp_async_commit();
  int ci = 0;
  for (int ch = 0; ch < plan.n_chains; ++ch) {
    const int h = plan.halo[ch];
    const int rows = TT + 2 * h;
    const int g0 = t0 - h;
    const int k = plan.k[ch];
    const int half = (k - 1) / 2;
    __syncthreads();  // the previous chain's centre rows have been read
    for (int i = threadIdx.x; i < rows * Q; i += NT) {
      const int r = i / Q, c = (i - r * Q) * 4;
      const int gr = g0 + r;
      const float4 v = (gr >= 0 && gr < T) ? load4(xb + (size_t)gr * C + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(xr + r * K::LDX + c) = v;
    }
    int rem = h;  // reach still ahead of the conv being run
    for (int p = 0; p < plan.n_pairs[ch]; ++p) {
      const int d = plan.dil[ch][p];
      rem -= half * d;
      conv<C, true>(xr, xa, wsm, buf, w + plan.w_off[ci], w + plan.w_off[ci + 1], bias + ci * C, k, d,
                    h - rem, h + TT + rem, g0, T, plan.rows);
      ++ci;
      rem -= half;
      conv<C, false>(xr, xa, wsm, buf, w + plan.w_off[ci],
                     ci + 1 < plan.n_convs ? w + plan.w_off[ci + 1] : nullptr, bias + ci * C, k, 1,
                     h - rem, h + TT + rem, g0, T, plan.rows);
      ++ci;
    }
    __syncthreads();
    const bool last = ch + 1 == plan.n_chains;
    for (int i = threadIdx.x; i < TT * Q; i += NT) {
      const int r = i / Q, c = (i - r * Q) * 4;
      const int gr = t0 + r;
      if (gr >= T) continue;
      const size_t o = (size_t)gr * C + c;
      float4 s = *reinterpret_cast<const float4*>(xr + (h + r) * K::LDX + c);
      if (ch > 0) {  // the same thread owns o in every chain
        const float4 prev = *reinterpret_cast<const float4*>(ab + o);
        s.x += prev.x, s.y += prev.y, s.z += prev.z, s.w += prev.w;
      }
      if (last) {
        const float n = (float)plan.n_chains;
        store4(ob + o, make_float4(s.x / n, s.y / n, s.z / n, s.w / n));
      } else {
        *reinterpret_cast<float4*>(ab + o) = s;
      }
    }
  }
  cp_async_wait<0>();
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
    trio_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, __nv_bfloat16* out, float* acc, int T, Plan plan) {
  trio_body<Bf16<C>>(x, w, bias, out, acc, T, plan);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
    trio_fp32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
              float* out, int T, Plan plan) {
  trio_body<Fp32<C>>(x, w, bias, out, out, T, plan);
}

template <typename K, typename Kernel>
int check_and_size(Kernel kernel, const Plan& plan, int smem) {
  if (plan.rows > K::PASS || (size_t)smem != K::bytes(plan.rows) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int C>
int launch_c(const void* x, const void* w, const float* bias, void* out, float* acc, int b, int t,
             const Plan& plan, int smem, int grid_x, bool bf16, cudaStream_t s) {
  const dim3 grid(grid_x, b);
  if (bf16) {
    if (int e = check_and_size<Bf16<C>>(trio_bf16<C>, plan, smem)) return e;
    trio_bf16<C><<<grid, NT, smem, s>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)w, bias,
                                        (__nv_bfloat16*)out, acc, t, plan);
  } else {
    if (int e = check_and_size<Fp32<C>>(trio_fp32<C>, plan, smem)) return e;
    trio_fp32<C><<<grid, NT, smem, s>>>((const float*)x, (const float*)w, bias, (float*)out, t, plan);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (ops/fused_stage.py::trio_plan): ks[n_chains] odd kernel sizes,
// n_pairs[n_chains], dils[n_chains * 3] (row-major, the first n_pairs[i] of
// row i used), halos[n_chains] (each the sum of its chain's conv reaches),
// rows (window rows), tt (output rows per block, rows >= tt + 2 max halo),
// smem (dynamic shared memory bytes, as the instantiation lays out rows
// window rows) and grid_x = ceil(t / tt). Checked here, then trusted.
// Weights and biases in chain order: chain i, pair p -> conv (k_i, dil) then
// conv (k_i, 1), each [k, C_in, C_out]. bf16 = 0: x, w and out are float
// and acc is out; 1: __nv_bfloat16, and acc an fp32 scratch of [B, T, C].
// Biases are fp32 either way.
extern "C" int sovits_resblock_trio(const void* x, const void* w, const float* bias, void* out,
                                    float* acc, int b, int t, int c, int n_chains,
                                    const int* ks, const int* n_pairs, const int* dils,
                                    const int* halos, int rows, int tt, int smem, int grid_x,
                                    int bf16, void* stream) {
  if (b < 1 || t < 1 || n_chains < 1 || n_chains > MAX_CHAINS || acc == nullptr)
    return (int)cudaErrorInvalidValue;
  Plan plan{};
  plan.n_chains = n_chains;
  long long off = 0;
  int ci = 0, hmax = 0;
  for (int i = 0; i < n_chains; ++i) {
    const int k = ks[i];
    if (k < 1 || k % 2 == 0 || n_pairs[i] < 1 || n_pairs[i] > MAX_PAIRS)
      return (int)cudaErrorInvalidValue;
    plan.k[i] = k;
    plan.n_pairs[i] = n_pairs[i];
    int halo = 0;
    for (int p = 0; p < n_pairs[i]; ++p) {
      const int d = dils[i * MAX_PAIRS + p];
      if (d < 1) return (int)cudaErrorInvalidValue;
      plan.dil[i][p] = d;
      halo += (k - 1) / 2 * (d + 1);
      plan.w_off[ci++] = off;
      off += (long long)k * c * c;
      plan.w_off[ci++] = off;
      off += (long long)k * c * c;
    }
    if (halos[i] != halo) return (int)cudaErrorInvalidValue;
    plan.halo[i] = halo;
    hmax = halo > hmax ? halo : hmax;
  }
  plan.n_convs = ci;
  plan.rows = rows;
  plan.tt = tt;
  if (tt < 16 || rows < tt + 2 * hmax || grid_x != (t + tt - 1) / tt) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 16: return launch_c<16>(x, w, bias, out, acc, b, t, plan, smem, grid_x, bf16, s);
    case 32: return launch_c<32>(x, w, bias, out, acc, b, t, plan, smem, grid_x, bf16, s);
    case 64: return launch_c<64>(x, w, bias, out, acc, b, t, plan, smem, grid_x, bf16, s);
    case 128: return launch_c<128>(x, w, bias, out, acc, b, t, plan, smem, grid_x, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

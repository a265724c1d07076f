// K4: the trio's staging microbench, on the H100's tensor cores.
//
// Replaces the TPU kernel tools/profile_trio_shift.py:make_kernel.run
// (Pallas body :46-99). That tool times one simplified ResBlock1-shaped
// chain under four ways of feeding a row-shifted operand to the TPU's
// matrix unit. The chain is 12 rounds of
//   x = lrelu_0.1(x);   x[r] = sum_{j=0..2} x[r + j - 1] . M[3i + j]
// on [rows, D] with D = 128 and 36 bf16 matrices [D, D], fp32 accumulation.
// The input xp is [Q + 32, D] bf16; output row g is the chain at xp row
// g + 16 (the TPU tool's 16-row halo), for g < rows = (Q / 1024) * 1024,
// which are the rows the TPU tool writes. The chain reaches 12 rows, less
// than the halo, so a row's result depends only on xp rows g + 4 .. g + 28.
//
// The TPU tool's four modes compute two functions. 'concat', 'roll' and
// 'scratch' differ only in how Mosaic presents a shifted view to the
// matrix unit; on Hopper a shifted view is another row base per lane, and
// all three round every intermediate to bf16: this kernel's bf16 variant.
// 'fp32in' keeps the intermediates fp32: the fp32 variant. In both, the
// first round's lrelu works on the bf16 input and is rounded to bf16, as
// the TPU tool's is.
//
// What bounds it on an H100: the products, 2 * 36 * rows * D^2 operations
// (64 GFLOP at the defaults); the 29 MB it moves are not what bounds it.
// bf16 runs at the bf16 tensor-core rate (0.065 ms at the defaults); fp32
// takes three bf16 products per fp32 one (0.194 ms).
//
// Block structure (both variants): one block per tile of tt output rows,
// tt from the wrapper's plan (profile_trio_shift.py::trio_shift_plan: whole
// waves of one block per SM), which this entry point checks and then
// trusts. The block holds a window of tt + 24 rows (12 on each side) of
// the round's A operand, lrelu(x) in the variant's type, in shared memory,
// and runs the 12 rounds in place: round i computes window rows [i + 1,
// window - i - 1), the rows later rounds still read; every warp keeps its
// fp32 sums in registers for the whole round (8 warps, 2 across the output
// columns, 4 across the rows, each up to 4 m16 row tiles: 256 rows, the
// window's cap), so after a barrier the epilogue overwrites the window with
// the next round's A. The 36 matrices stream through shared memory one tap
// at a time, as they are packed ([C_in][C_out], row stride C + 8), double-
// buffered with cp.async: one barrier a tap, the next tap (across rounds
// too) in flight while this one is multiplied. B fragments come by
// ldmatrix.trans; a shift of -1, 0 or +1 rows is another row base for A.
//
// bf16: mma.sync.m16n8k16 bf16 with fp32 sums. The window is bf16 [window]
// [C + 8] (272-byte rows, 17 chunks of 16 bytes: ldmatrix conflict-free),
// A by ldmatrix. A round's epilogue stores bf16(lrelu(bf16(sum))), the
// plain version's next A exactly; the last round stores bf16(sum). Per warp
// and 16-deep step, 4 ldmatrix.x4 for B and 4 for A feed up to 32 MMAs: 128
// bytes of shared memory per MMA (fp32: 4 ldmatrix.x4 and 16 8-byte A reads
// per 96 MMAs, 64 bytes).
//
// fp32: the window is fp32 [window][C + 8] (8-byte reads conflict-free).
// The matrices are bf16, so only A needs splitting: each A value read
// (lrelu already applied) is split in registers into three bf16 parts, hi +
// mid + lo (24 bits of its 24-bit mantissa), and every 16-deep step sums
// lo.M + mid.M + hi.M from zero and then adds that to its fp32 total: the
// tensor cores do not round their own sums to nearest. The last round
// stores the fp32 sums; they are rounded to bf16 once, on the way out. The
// same structure as 2xTF32 (hi + lo in tf32, two m16n8k8 products per
// 8-deep step: 4 MMA issue slots per 16 deep against 3) was 1.1x slower on
// an H100 and took 254 registers against 208 (PERF.md).
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;        // P * C, the folded width
constexpr int NT = 256;       // threads, 8 warps
constexpr int WN = 2;         // warps across the output columns
constexpr int WM = NT / 32 / WN;  // warps across the rows
constexpr int NN = D / WN / 8;    // n8 tiles a warp
constexpr int MI = 4;             // m16 row tiles a warp
constexpr int PASS = WM * MI * 16;  // rows one round can compute: the window's cap
constexpr int N_CONV = 12;    // rounds; the chain's reach in rows
constexpr int N_TAP = 3;      // shifts -1, 0, 1
constexpr int HALO = 16;      // the TPU tool's halo rows before output row 0
constexpr int LD = D + 8;     // row stride (elements) of the window and of a staged tap
constexpr int WBUF = D * LD;  // one staged tap [C_in][C_out + 8] bf16
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may opt in to
constexpr float SLOPE = 0.1f;

template <typename S>
size_t smem_bytes(int window) {
  return 2 * (size_t)WBUF * sizeof(bf16) + (size_t)window * LD * sizeof(S);
}

__device__ __forceinline__ float lrelu(float x) { return fmaxf(x, SLOPE * x); }

// c = a . b on a 16x8x16 bf16 tile, summed from zero
__device__ __forceinline__ void mma_bf16_from_zero(float c[4], const uint32_t a[4], uint32_t b0,
                                                   uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Matrix s (round s / 3, shift s % 3 - 1) of the 36 packed [C_in][C_out]
// into dst [C_in][LD].
__device__ __forceinline__ void issue_tap(const bf16* __restrict__ mats, int s, bf16* dst) {
  const bf16* src = mats + (size_t)s * D * D;
  for (int i = threadIdx.x; i < D * D / 8; i += NT) {
    const int r = i >> 4, p = (i & 15) * 8;
    cp_async16(dst + r * LD + p, src + r * D + p, true);
  }
}

// B of the 16-deep step kk, this warp's NN n8 tiles from column n0 on.
__device__ __forceinline__ void load_b(uint32_t (&b)[NN][2], const bf16* wb, int kk, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    uint32_t r4[4];
    ldsm_x4_t(r4, wb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + np * 16 + (lane >> 4) * 8);
    b[2 * np][0] = r4[0];
    b[2 * np][1] = r4[1];
    b[2 * np + 1][0] = r4[2];
    b[2 * np + 1][1] = r4[3];
  }
}

// One tap of a round, bf16: acc[r] += A[r + shift] . W over this warp's row
// tiles (first row of each: lo + (wm + mi WM) 16) and columns. A rows past
// the window's cap are clamped into it; tiles past the round's rows are
// loaded and not multiplied.
__device__ __forceinline__ void tap(float (&acc)[MI][NN][4], const bf16* win, const bf16* wb, int shift,
                                    int lo, int wm, int n0, int n_act, int cap) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[NN][2];
    load_b(b, wb, kk, n0);
    uint32_t a[MI][4];  // every tile's A before the MMAs: faster on an H100 than one tile at a time
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r = min(lo + (wm + mi * WM) * 16 + shift + (lane & 7) + ((lane >> 3) & 1) * 8, cap - 1);
      ldsm_x4(a[mi], win + r * LD + kk * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (mi >= n_act) break;
#pragma unroll
      for (int n = 0; n < NN; ++n) mma_bf16(acc[mi][n], a[mi], b[n][0], b[n][1]);
    }
  }
}

// x = hi + mid + lo, three bf16 pairs (.x in the low half): each part is the
// remainder so far rounded to bf16; the remainders are exact in fp32.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r.x - mf.x, r.y - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One tap of a round, fp32 window: A split into three bf16 parts, each
// 16-deep step's three products summed from zero and added to acc.
__device__ __forceinline__ void tap(float (&acc)[MI][NN][4], const float* win, const bf16* wb, int shift,
                                    int lo, int wm, int n0, int n_act, int cap) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[NN][2];
    load_b(b, wb, kk, n0);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (mi >= n_act) break;
      const int r0 = lo + (wm + mi * WM) * 16 + shift;
      const float* pa = win + min(r0 + g, cap - 1) * LD + kk * 16 + 2 * tq;
      const float* pb = win + min(r0 + g + 8, cap - 1) * LD + kk * 16 + 2 * tq;
      uint32_t ah[4], am[4], al[4];
      split3(*reinterpret_cast<const float2*>(pa), ah[0], am[0], al[0]);
      split3(*reinterpret_cast<const float2*>(pb), ah[1], am[1], al[1]);
      split3(*reinterpret_cast<const float2*>(pa + 8), ah[2], am[2], al[2]);
      split3(*reinterpret_cast<const float2*>(pb + 8), ah[3], am[3], al[3]);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        float t[4];
        mma_bf16_from_zero(t, al, b[n][0], b[n][1]);
        mma_bf16(t, am, b[n][0], b[n][1]);
        mma_bf16(t, ah, b[n][0], b[n][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] += t[e];
      }
    }
  }
}

// The round's result for window row r, columns c and c + 1: the next
// round's A (lrelu, in the window's type), or on the last round the sum
// (bf16 rounded to bf16 here; fp32 on the way out).
__device__ __forceinline__ void store_pair(bf16* p, float y0, float y1, bool last) {
  if (!last) {
    const float2 y = __bfloat1622float2(__floats2bfloat162_rn(y0, y1));  // the bf16 intermediate
    y0 = lrelu(y.x);
    y1 = lrelu(y.y);
  }
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(y0, y1);
}
__device__ __forceinline__ void store_pair(float* p, float y0, float y1, bool last) {
  *reinterpret_cast<float2*>(p) = last ? make_float2(y0, y1) : make_float2(lrelu(y0), lrelu(y1));
}

// Round ci over window rows [lo, hi): three taps, then, once every warp has
// read the window, the epilogue in place. On entry matrix 3 ci is in flight
// into wsm[buf].
template <typename S>
__device__ __forceinline__ void conv_round(S* win, bf16* wsm, int& buf, const bf16* __restrict__ mats, int ci,
                                           int lo, int hi, int cap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int n0 = wn * (D / WN);
  int n_act = 0;  // this warp's row tiles inside [lo, hi): tile i goes to warp row i mod WM
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) n_act += lo + (wm + mi * WM) * 16 < hi;
  float acc[MI][NN][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

  for (int j = 0; j < N_TAP; ++j) {
    const int s = ci * N_TAP + j;
    cp_async_wait<0>();
    __syncthreads();  // matrix s is in wsm[buf] for all; everyone is done with wsm[buf ^ 1]
    if (s + 1 < N_CONV * N_TAP) issue_tap(mats, s + 1, wsm + (buf ^ 1) * WBUF);
    cp_async_commit();
    const bf16* wb = wsm + buf * WBUF;
    buf ^= 1;
    if (n_act > 0) tap(acc, win, wb, j - 1, lo, wm, n0, n_act, cap);
  }
  __syncthreads();  // every warp has read the window
  const bool last = ci + 1 == N_CONV;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (mi >= n_act) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = lo + (wm + mi * WM) * 16 + g + 8 * hr;
      if (r >= hi) continue;
#pragma unroll
      for (int n = 0; n < NN; ++n)
        store_pair(win + r * LD + n0 + n * 8 + 2 * tq, acc[mi][n][2 * hr], acc[mi][n][2 * hr + 1], last);
    }
  }
}

// 8 bf16 values -> bf16(lrelu(v)), into the window's type
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  float r[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) r[e] = __bfloat162float(__float2bfloat16(v[e]));
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(r[4], r[5], r[6], r[7]);
}
__device__ __forceinline__ uint4 load8(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

template <typename S>
__global__ void __launch_bounds__(NT, 1)
    trio_shift_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ mats, bf16* __restrict__ out,
                      int rows, int tt) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* wsm = reinterpret_cast<bf16*>(smraw);  // two staged taps
  S* win = reinterpret_cast<S*>(wsm + 2 * WBUF);  // the window [tt + 24][LD]
  const int cap = tt + 2 * N_CONV;
  const int t0 = blockIdx.x * tt;
  const int n = min(tt, rows - t0);
  const int w_rows = n + 2 * N_CONV;
  int buf = 0;
  issue_tap(mats, 0, wsm);
  cp_async_commit();
  // round 0's A: bf16(lrelu(xp)) for window rows from xp row t0 + HALO - N_CONV
  const bf16* src = xp + (size_t)(t0 + HALO - N_CONV) * D;
  for (int i = threadIdx.x; i < w_rows * (D / 8); i += NT) {
    const int r = i >> 4, c = (i & 15) * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[2 * e] = lrelu(f.x);
      v[2 * e + 1] = lrelu(f.y);
    }
    store8(win + r * LD + c, v);
  }
  for (int ci = 0; ci < N_CONV; ++ci) conv_round<S>(win, wsm, buf, mats, ci, ci + 1, w_rows - ci - 1, cap);
  __syncthreads();
  bf16* dst = out + (size_t)t0 * D;
  for (int i = threadIdx.x; i < n * (D / 8); i += NT) {
    const int r = i >> 4, c = (i & 15) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * D + c) = load8(win + (N_CONV + r) * LD + c);
  }
  cp_async_wait<0>();
}

template <typename S>
int launch(const void* xp, const void* mats, void* out, int rows, int tt, int window, int smem, int blocks,
           cudaStream_t stream) {
  if (window != tt + 2 * N_CONV || window > PASS || (size_t)smem != smem_bytes<S>(window) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaFuncSetAttribute(trio_shift_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem))
    return (int)e;
  trio_shift_kernel<S><<<blocks, NT, smem, stream>>>((const bf16*)xp, (const bf16*)mats, (bf16*)out, rows, tt);
  return (int)cudaGetLastError();
}

}  // namespace

// xp [rows + 32, D] bf16 (at least; 16-byte aligned), mats [36, D, D] bf16,
// out [rows, D] bf16. fp32_stage = 0: the bf16 variant ('concat', 'roll',
// 'scratch'); 1: 'fp32in'. The plan (profile_trio_shift.py::
// trio_shift_plan): tt output rows per block, window = tt + 24 rows, smem
// bytes as the variant lays out that window, blocks = ceil(rows / tt).
// Checked here, then trusted.
extern "C" int sovits_trio_shift(const void* xp, const void* mats, void* out, int rows, int d, int fp32_stage,
                                 int tt, int window, int smem, int blocks, void* stream) {
  if (rows < 1 || d != D || tt < 1 || blocks != (rows + tt - 1) / tt) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fp32_stage) return launch<float>(xp, mats, out, rows, tt, window, smem, blocks, s);
  return launch<bf16>(xp, mats, out, rows, tt, window, smem, blocks, s);
}

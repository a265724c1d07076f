// K4: the trio's staging microbench, on Hopper.
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
// matrix unit; on Hopper a shifted view is an offset into the shared-memory
// tile, and all three round every intermediate to bf16: that is this
// kernel's bf16 staging (S = __nv_bfloat16). 'fp32in' keeps the
// intermediates fp32 (S = float). In both, the first round's lrelu works on
// the bf16 input and is rounded to bf16, as the TPU tool's is.
//
// Design: one block per tile of TT output rows. It loads the tile plus 12
// rows on each side into shared memory in the staging type, and runs the 12
// rounds between two buffers, each round computing one row fewer on each
// side. Each thread holds a TM x D/16 tile of fp32 sums; the matrices are
// staged 16 input rows at a time, widened to fp32; products are fp32 FMA.
// TT is chosen so that the blocks fill whole waves of one block per SM. bf16
// staging halves the tile's bytes, so its tiles are about twice as long and
// recompute less of the halo; that, and the rounding, are what differ.
//
// What bounds it on an H100: the products, 2 * 36 * rows * D^2 operations
// (64 GFLOP at the defaults), about 0.065 ms at the bf16 tensor-core peak and
// 0.96 ms at the fp32 peak; the 29 MB it moves are not what bounds it. This
// first version runs fp32 FMA from shared memory and uses no tensor cores.
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int D = 128;        // P * C, the folded width
constexpr int NT = 256;       // threads: 16 column groups x 16 row groups
constexpr int N_CONV = 12;    // rounds; the chain's reach in rows
constexpr int N_SHIFT = 3;    // shifts -1, 0, 1
constexpr int HALO = 16;      // the TPU tool's halo rows before output row 0
constexpr int KC = 16;        // matrix rows staged per chunk
constexpr int TN = D / 16;    // output columns per thread
constexpr int TM = 8;         // rows per thread per pass
constexpr int PASS = 16 * TM; // rows per pass
constexpr int SMEM_BYTES = 225 * 1024;
constexpr float SLOPE = 0.1f;

template <typename S>
struct Cfg {
  // row stride in elements: neighbouring rows an odd number of 4-byte words apart
  static constexpr int LD = D + (sizeof(S) == 4 ? 1 : 2);
  static constexpr int R_MAX = (SMEM_BYTES - KC * D * 4) / (2 * LD * (int)sizeof(S));
  static constexpr int TT_MAX = R_MAX - 2 * N_CONV;
  static constexpr int SMEM = 2 * R_MAX * LD * (int)sizeof(S) + KC * D * 4;
  static_assert(SMEM <= SMEM_BYTES, "shared memory budget");
  static_assert((2 * R_MAX * LD * (int)sizeof(S)) % 4 == 0, "fp32 weights stay aligned");
};

// One round: dst[r] = sum_j A[r + j - 1] . M[j] for r in [lo, hi), with
// A = lrelu(in), rounded to bf16 when round_a; dst is written in S.
template <typename S>
__device__ __forceinline__ void round_conv(const S* __restrict__ in, S* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ m,
                                           float* __restrict__ wst, int lo, int hi,
                                           bool round_a) {
  using K = Cfg<S>;
  const int tid = threadIdx.x;
  const int cg = tid & 15;
  const int rg = tid >> 4;
  for (int r0 = lo; r0 < hi; r0 += PASS) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;
    for (int j = 0; j < N_SHIFT; ++j) {
      const int shift = j - 1;
      for (int c0 = 0; c0 < D; c0 += KC) {
        __syncthreads();  // the previous chunk (and the previous round) is done
        const __nv_bfloat16* mj = m + ((size_t)j * D + c0) * D;
        for (int i = tid; i < KC * D; i += NT) wst[i] = __bfloat162float(mj[i]);
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < KC; ++cc) {
          float a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r = r0 + rg + 16 * i;
            float x = 0.f;
            if (r < hi) x = to_f(in[(r + shift) * K::LD + c0 + cc]);
            x = fmaxf(x, SLOPE * x);
            a[i] = round_a ? round_to<__nv_bfloat16>(x) : x;
          }
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const float b = wst[cc * D + cg + 16 * n];
#pragma unroll
            for (int i = 0; i < TM; ++i) acc[i][n] = fmaf(a[i], b, acc[i][n]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + rg + 16 * i;
      if (r >= hi) continue;
#pragma unroll
      for (int n = 0; n < TN; ++n) dst[r * K::LD + cg + 16 * n] = from_f<S>(acc[i][n]);
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(NT, 1)
    trio_shift_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ mats,
                      __nv_bfloat16* __restrict__ out, int rows, int tt) {
  using K = Cfg<S>;
  extern __shared__ __align__(16) unsigned char smraw[];
  S* buf[2];
  buf[0] = reinterpret_cast<S*>(smraw);
  buf[1] = buf[0] + K::R_MAX * K::LD;
  float* wst = reinterpret_cast<float*>(buf[1] + K::R_MAX * K::LD);
  constexpr bool kBf16 = sizeof(S) == 2;

  const int t0 = blockIdx.x * tt;
  const int n = min(tt, rows - t0);
  const int r_rows = n + 2 * N_CONV;
  const __nv_bfloat16* src = xp + (size_t)(t0 + HALO - N_CONV) * D;
  for (int i = threadIdx.x; i < r_rows * D; i += NT) {
    const int r = i / D, c = i - r * D;
    buf[0][r * K::LD + c] = from_f<S>(__bfloat162float(src[i]));
  }
  for (int ci = 0; ci < N_CONV; ++ci) {
    round_conv<S>(buf[ci & 1], buf[(ci + 1) & 1], mats + (size_t)ci * N_SHIFT * D * D, wst,
                  ci + 1, r_rows - ci - 1, kBf16 || ci == 0);
  }
  __syncthreads();
  const S* res = buf[N_CONV & 1];
  __nv_bfloat16* dst = out + (size_t)t0 * D;
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, c = i - r * D;
    dst[i] = __float2bfloat16(to_f(res[(N_CONV + r) * K::LD + c]));
  }
}

template <typename S>
int launch(const void* xp, const void* mats, void* out, int rows, cudaStream_t stream) {
  using K = Cfg<S>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(trio_shift_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::SMEM);
  if (e != cudaSuccess) return (int)e;
  // whole waves of one block per SM, each tile at most TT_MAX rows
  const long long per_wave = (long long)sms * K::TT_MAX;
  const int waves = (int)((rows + per_wave - 1) / per_wave);
  const int tt = (int)((rows + (long long)sms * waves - 1) / ((long long)sms * waves));
  const int blocks = (rows + tt - 1) / tt;
  trio_shift_kernel<S><<<blocks, NT, K::SMEM, stream>>>(
      (const __nv_bfloat16*)xp, (const __nv_bfloat16*)mats, (__nv_bfloat16*)out, rows, tt);
  return (int)cudaGetLastError();
}

}  // namespace

// xp [rows + 32, D] bf16 (at least), mats [36, D, D] bf16, out [rows, D] bf16.
// fp32_stage = 0: bf16 staging ('concat', 'roll', 'scratch'); 1: 'fp32in'.
extern "C" int sovits_trio_shift(const void* xp, const void* mats, void* out, int rows, int d,
                                 int fp32_stage, void* stream) {
  if (rows < 1 || d != D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fp32_stage) return launch<float>(xp, mats, out, rows, s);
  return launch<__nv_bfloat16>(xp, mats, out, rows, s);
}

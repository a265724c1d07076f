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
// convs are packed in chain order as [k, C_in, C_out] each; biases [18, C].
// The TPU kernel time-folds to [T/P, P*C] with P*C = 128 to fill its matrix
// unit; that is TPU layout work and has no counterpart here.
//
// Design: one block per (batch row, tile of TT output rows). The block runs
// the three chains one after another. For each chain it loads the tile plus
// that chain's own halo (12, 36 and 60 rows on each side for k = 3, 7, 11:
// the sum of the chain's six conv reaches) into shared memory, runs the six
// convs on chip -- the residual stream in one buffer, the inner activation in
// a second -- and adds the chain's centre rows into the output. Each conv
// computes only the rows the rest of the chain still reads, so the halo
// costs 6*TT + 2*sum(remaining reach) rows per chain, not 6*(TT + 2*halo).
// Intermediates never touch device memory; x is read once per chain and the
// output is written three times by the block that owns it.
//
// What bounds it on an H100: arithmetic. A 10 s clip needs about 0.43
// TFLOP across the four stages (C = 128, 64, 32, 16), plus the halo
// recompute, and this first version runs it as fp32 FMA from shared memory
// (each thread a TM x C/16 register tile; weights staged 16 input channels
// at a time). The two window buffers fill the 227 KB a block may use, so one
// block of 8 warps runs per SM: latency, not bandwidth, limits it. Tensor
// cores (mma.sync / wgmma on tf32 or bf16) are the next step.
//
// bf16 (the JAX package's bf16 serving path): x, the weights and the output
// are bf16, the biases fp32, as the TPU kernel takes them (fused_stage.py:
// 129-130). x and the weights are widened to fp32 as they are staged, and
// the residual stream, every intermediate and the mean stay fp32 (the TPU
// kernel's fp32 chain, :183, :215); the mean is rounded to bf16 once. Each
// conv's input stays exact fp32, as in the TPU kernel's interpret mode (on
// the TPU the matrix unit's default precision would round it to bf16). The
// mean over the chains is summed in an fp32 scratch [B, T, C] (for fp32 the
// output itself) and written as bf16 after the last chain.
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int NT = 256;            // threads: 16 channel groups x 16 row groups
constexpr int MAX_CHAINS = 3;
constexpr int MAX_PAIRS = 3;
constexpr int MAX_CONVS = 2 * MAX_CHAINS * MAX_PAIRS;
constexpr int SMEM_BYTES = 225 * 1024;  // under the 227 KB a block may opt in to
constexpr float SLOPE = 0.1f;

struct Plan {
  int n_chains;
  int k[MAX_CHAINS];
  int n_pairs[MAX_CHAINS];
  int dil[MAX_CHAINS][MAX_PAIRS];
  int halo[MAX_CHAINS];
  long long w_off[MAX_CONVS];  // element offset of each conv's [k, C, C] weights
};

template <int C>
struct Cfg {
  static constexpr int LD = C + 1;            // row stride: two rows per warp, two banks
  static constexpr int KC = 16;               // input channels per staged weight chunk
  static constexpr int TN = C / 16;           // output channels per thread
  static constexpr int TM = 8;                // rows per thread per pass
  static constexpr int PASS = 16 * TM;        // rows per pass
  static constexpr int R_MAX = (SMEM_BYTES - KC * C * 4) / (2 * LD * 4);
  static constexpr int SMEM = (2 * R_MAX * LD + KC * C) * 4;
  static_assert(C % 16 == 0, "C must be a multiple of 16");
  static_assert(SMEM <= SMEM_BYTES, "shared memory budget");
};

// One 'same' conv over window rows [lo, hi): reads lrelu(in[r + (j-h)*d]),
// writes (or, with accumulate, adds) bias + sum into dst, zero outside [0, T).
template <int C, typename T_>
__device__ __forceinline__ void conv(const float* __restrict__ in, float* __restrict__ dst,
                                     bool accumulate, const T_* __restrict__ w,
                                     const float* __restrict__ bias, float* __restrict__ wst,
                                     int k, int d, int lo, int hi, int g0, int T) {
  using K = Cfg<C>;
  const int tid = threadIdx.x;
  const int cg = tid & 15;
  const int rg = tid >> 4;
  const int half = (k - 1) / 2;
  for (int r0 = lo; r0 < hi; r0 += K::PASS) {
    float acc[K::TM][K::TN];
#pragma unroll
    for (int m = 0; m < K::TM; ++m)
#pragma unroll
      for (int n = 0; n < K::TN; ++n) acc[m][n] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int shift = (j - half) * d;
      for (int c0 = 0; c0 < C; c0 += K::KC) {
        __syncthreads();  // everyone is done with the previous chunk (and the previous conv)
        const T_* wj = w + ((size_t)j * C + c0) * C;
        for (int i = tid; i < K::KC * C; i += NT) wst[i] = to_f(wj[i]);
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < K::KC; ++cc) {
          float a[K::TM];
#pragma unroll
          for (int m = 0; m < K::TM; ++m) {
            const int r = r0 + rg + 16 * m;
            float x = 0.f;
            if (r < hi) x = in[(r + shift) * K::LD + c0 + cc];
            a[m] = fmaxf(x, SLOPE * x);
          }
#pragma unroll
          for (int n = 0; n < K::TN; ++n) {
            const float b = wst[cc * C + cg + 16 * n];
#pragma unroll
            for (int m = 0; m < K::TM; ++m) acc[m][n] = fmaf(a[m], b, acc[m][n]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < K::TM; ++m) {
      const int r = r0 + rg + 16 * m;
      if (r >= hi) continue;
      const int g = g0 + r;
      const bool inside = g >= 0 && g < T;
#pragma unroll
      for (int n = 0; n < K::TN; ++n) {
        const int c = cg + 16 * n;
        const float y = inside ? acc[m][n] + bias[c] : 0.f;
        if (accumulate)
          dst[r * K::LD + c] += y;
        else
          dst[r * K::LD + c] = y;
      }
    }
  }
}

template <int C, typename T_>
__global__ void __launch_bounds__(NT, 1)
    trio_kernel(const T_* __restrict__ x, const T_* __restrict__ w,
                const float* __restrict__ bias, T_* out, float* acc, int T, int TT,
                Plan plan) {
  using K = Cfg<C>;
  extern __shared__ float sm[];
  float* xr = sm;                  // residual stream [R_MAX][LD]
  float* xt = xr + K::R_MAX * K::LD;  // inner activation [R_MAX][LD]
  float* wst = xt + K::R_MAX * K::LD;  // staged weights [KC][C]

  const int t0 = blockIdx.x * TT;
  const T_* xb = x + (size_t)blockIdx.y * T * C;
  T_* ob = out + (size_t)blockIdx.y * T * C;
  float* ab = acc + (size_t)blockIdx.y * T * C;  // for fp32 the output itself
  int ci = 0;
  for (int ch = 0; ch < plan.n_chains; ++ch) {
    const int h = plan.halo[ch];
    const int rows = TT + 2 * h;
    const int g0 = t0 - h;
    const int k = plan.k[ch];
    const int half = (k - 1) / 2;
    __syncthreads();  // the previous chain's centre rows have been read
    for (int i = threadIdx.x; i < rows * C; i += NT) {
      const int r = i / C, c = i - r * C;
      const int g = g0 + r;
      xr[r * K::LD + c] = (g >= 0 && g < T) ? to_f(xb[(size_t)g * C + c]) : 0.f;
    }
    int rem = h;  // reach still ahead of the conv being run
    for (int p = 0; p < plan.n_pairs[ch]; ++p) {
      const int d = plan.dil[ch][p];
      rem -= half * d;
      conv<C, T_>(xr, xt, false, w + plan.w_off[ci], bias + ci * C, wst, k, d, h - rem,
              h + TT + rem, g0, T);
      ++ci;
      rem -= half;
      conv<C, T_>(xt, xr, true, w + plan.w_off[ci], bias + ci * C, wst, k, 1, h - rem,
              h + TT + rem, g0, T);
      ++ci;
    }
    __syncthreads();
    const bool last = ch + 1 == plan.n_chains;
    for (int i = threadIdx.x; i < TT * C; i += NT) {
      const int r = i / C, c = i - r * C;
      const int g = t0 + r;
      if (g >= T) continue;
      const size_t o = (size_t)g * C + c;
      const float y = xr[(h + r) * K::LD + c];
      const float s = ch == 0 ? y : ab[o] + y;  // same thread owns o in every chain
      if (last)
        ob[o] = from_f<T_>(s / (float)plan.n_chains);
      else
        ab[o] = s;
    }
  }
}

template <int C, typename T_>
int launch(const void* x, const void* w, const float* bias, void* out, float* acc, int b, int t,
           const Plan& plan, cudaStream_t stream) {
  using K = Cfg<C>;
  int hmax = 0;
  for (int i = 0; i < plan.n_chains; ++i) hmax = plan.halo[i] > hmax ? plan.halo[i] : hmax;
  const int tt = K::R_MAX - 2 * hmax;
  if (tt < 16) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(trio_kernel<C, T_>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + tt - 1) / tt, b);
  trio_kernel<C, T_><<<grid, NT, K::SMEM, stream>>>((const T_*)x, (const T_*)w, bias, (T_*)out,
                                                    acc, t, tt, plan);
  return (int)cudaGetLastError();
}

template <typename T_>
int launch_c(int c, const void* x, const void* w, const float* bias, void* out, float* acc, int b,
             int t, const Plan& plan, cudaStream_t s) {
  switch (c) {
    case 16: return launch<16, T_>(x, w, bias, out, acc, b, t, plan, s);
    case 32: return launch<32, T_>(x, w, bias, out, acc, b, t, plan, s);
    case 64: return launch<64, T_>(x, w, bias, out, acc, b, t, plan, s);
    case 128: return launch<128, T_>(x, w, bias, out, acc, b, t, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ks[n_chains]: odd kernel sizes; n_pairs[n_chains]; dils[n_chains * 3]
// (row-major, the first n_pairs[i] of row i used). Weights and biases in
// chain order: chain i, pair p -> conv (k_i, dil) then conv (k_i, 1).
// bf16 = 0: x, w and out are float and acc is out; 1: __nv_bfloat16, and
// acc an fp32 scratch of [B, T, C]. Biases are fp32 either way.
extern "C" int sovits_resblock_trio(const void* x, const void* w, const float* bias, void* out,
                                    float* acc, int b, int t, int c, int n_chains,
                                    const int* ks, const int* n_pairs, const int* dils,
                                    int bf16, void* stream) {
  if (b < 1 || t < 1 || n_chains < 1 || n_chains > MAX_CHAINS) return (int)cudaErrorInvalidValue;
  Plan plan{};
  plan.n_chains = n_chains;
  long long off = 0;
  int ci = 0;
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
    plan.halo[i] = halo;
  }
  if (acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch_c<__nv_bfloat16>(c, x, w, bias, out, acc, b, t, plan, s);
  return launch_c<float>(c, x, w, bias, out, acc, b, t, plan, s);
}

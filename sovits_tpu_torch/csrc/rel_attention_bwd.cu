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
// Like the TPU kernel, masked positions are not replayed in ds: ds is p
// times (g - D) wherever p is not 0, which matters only on a row whose keys
// are all masked (uniform p).
//
// Blocks run in no order, so nothing is carried across the grid and no
// atomics are used; two passes, each deterministic:
//   (a) one block per (bh, 32 query rows in fp32, 16 in bf16) streams the
//       key tiles and computes dq, D, and the per-block partials of drel_k
//       and drel_v (sums over query rows), into a scratch array [n_blocks,
//       2, 2w+1, D] that the caller sums, as the JAX package sums its
//       per-program partials. It also stores D, and q . rel_k and dout .
//       rel_v per row ([BH, T, 2 (2w+1)]), for pass (b).
//   (b) one block per (bh, 32 keys in fp32, 16 in bf16) streams the query
//       tiles and computes dk and dv.
// The tiling is ops/attention.py::bwd_plan's, which the entry point checks.
// Causal without a key mask (the F0Decoder), every row has a valid key at
// or before its diagonal, so a key above the diagonal has p = exp(-1e4 -
// lse) = 0 exactly in fp32 (and in bf16): those tiles are skipped. With a
// key mask they are not (a fully masked row is uniform over all keys).
//
// fp32 (bwd_q_tf32, bwd_kv_tf32): the T^2 D products run on the tensor
// cores as 3xTF32 on mma.sync.m16n8k8.tf32, as K1 takes them: each operand
// split into tf32 hi and lo, lo.hi + hi.lo + hi.hi, each 8-deep step's
// products summed from zero and added to an fp32 total, rounded to nearest
// (the tensor cores' own sums are not; one-pass TF32 misses the fp32 bar).
// A warp owns 16 query rows (pass (a)) or 16 keys (pass (b)), the
// FlashAttention-2 backward's layout: pass (b) takes S^T = K . q^T and G^T
// = V . dout^T, so that pt^T and ds^T land in the C layout, whose registers
// are the A operands of dv += pt^T . dout and dk += ds^T . q as they are
// (A column t <-> C column 2t, t + 4 <-> 2t + 1, the B rows following, as
// K1 does for P); pass (a) takes S and G the same way and dq += ds . k.
// K and V (pass (b)), q and dout (pass (a)) stay resident; the other side
// streams through shared memory by cp.async, double buffered, rows of D
// zero-padded to 32, 64, 96 or 128 (plus a pad that keeps the fragment
// loads free of bank conflicts), or loaded element by element where a row
// is not a whole number of 16-byte chunks. The band products (q . rel_k,
// dout . rel_v, band(ds) . rel_k, the rel-table partials) stay fp32 FMA.
//
// fp32 D, and the one-key row. On a row with one key (causal row 0, the
// F0Decoder) the plain version's ds = 1 (g - g) is exactly 0, and the card
// tests hold that row's dq to 1e-5. D is taken as dout . out (the same
// number as sum_u g p: out[t] = sum_u pt[t, u] v[u] + the value band) with
// fp32 FMA, which is not the 3xTF32 g to the last bit, so g - D would not
// cancel there. Instead pass (a) replays S with K1's arithmetic to the bit
// (mma.cuh's split and mma_3xtf32_step, in K1's operand and step order), so
// on such a row p = exp(s - lse) is exactly 1, and ds is set to 0 wherever
// p == 1. That makes dq exact where it matters: p rounds to 1 only if the
// row's other keys hold under 3e-8 of its mass, where the true ds is below
// 3e-8 |g|. Pass (b) zeroes ds where its own p == 1 too, but its S^T = K .
// q^T sums in another order, so there p may miss 1 by an ulp and dk and dv
// keep g - D's rounding noise (about 1e-6 |g|, far inside the fp32 bar): the
// route is exact for dq only. It costs no product; a sweep over the keys
// for D = rowsum(g p), which bf16 takes (below), would cost two more T^2 D
// products and a third pass over the dropout mask.
//
// bf16 (bwd_q_bf16, bwd_kv_bf16): the same layout on mma.sync.m16n8k16 bf16
// with fp32 sums (a product of two bf16 values is exact in fp32), one
// instruction a product; two m16n8 C tiles of p, pt or ds pack into one
// m16n8k16 A fragment (as K1 packs P), and the B operands come by ldmatrix
// (.trans for dq += ds . K, dv += pt^T . dout and dk += ds^T . q). To fill
// the card at bench.py's T 512, a block owns 16 rows (query rows in (a),
// keys in (b)) and its 4 warps split the other side's tiles, adding their
// sums in shared memory in a fixed order. Rows of bf16 padded to DP + 8
// elements keep ldmatrix free of bank conflicts. The kernel rounds where the
// TPU kernel does (_bwd_kernel in q's type): p to bf16 (its stored p_lo)
// before anything uses it; pt = p dm, and ds, to bf16 where they enter a
// product (dv, dq, dk and both band terms); g, D and ds themselves stay
// fp32; dq, dk and dv are rounded once, at the store. out is not read: bf16
// out is rounded after its sum, so dout . out would leave a one-key row's
// dq at rounding noise. Pass (a) sweeps the keys twice in one loop body:
// the first sweep sums D = sum_u g dm p per row, the second takes ds = p (g
// dm - D) and dq; S, G, p and g dm are the same instructions in both (g dm
// rounded before the subtraction, never fused into it). On a row with one
// key, exp(s - lse) is within 2^-9 of 1 and p rounds to exactly 1, every
// other p is 0, so D is that key's g dm to the bit and ds, and the row's dq,
// are exactly 0, as the plain version's. Pass (b) takes S^T = K . q^T, which
// sums in another order, so its ds on that row keeps fp32 rounding noise
// (about 1e-7 |g|), in dk only.
//
// What bounds it on an H100: at the fp32 training shape (BH 12, T 800, D
// 96) 5 products of 2 T^2 D are needed (1.47 GFLOP each); fp32 takes 7 (S
// and G in both passes) on the tensor cores, against about 0.1 GB of traffic
// (the 30.7 MB dropout mask read once per pass): operation-bound, 0.045 ms
// at the 3xTF32 rate. bf16 (bench.py's step, T 512) takes 9 products (the D
// sweep's S and G too) at the bf16 rate, 5.4 GFLOP, about 5 us, under its
// bytes (0.0062 ms): bytes-bound. What holds both back is latency: pass (a)'s
// fp32 600 warps (16 rows each) leave 4-5 warps an SM, each issuing
// dependent mma chains (pass (b) splits each 16 keys' query tiles over two
// warps: 1200); bf16 runs 4 warps per 16 rows in both passes (1536 each at
// T 512), three blocks an SM. Pre-split tiles in shared memory, wgmma and an
// in-kernel Philox mask are later work.
//
// Plain C interface, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXD = 128;
constexpr float NEG = -1e4f;  // the reference's masking constant

// ---- fp32 on the tensor cores: 3xTF32 on mma.sync.m16n8k8.tf32 ----

// pass (b): groups of 16 keys per block, each owned by KV_QSPLIT warps that
// take 16 rows of every query tile each (so 2x the warps of 16 keys alone)
constexpr int KV_GROUPS = 2, KV_QSPLIT = 2;
constexpr int KV_KEYS = 16 * KV_GROUPS;  // keys per pass-(b) block
constexpr int QT = 16 * KV_QSPLIT;       // query rows per streamed tile of pass (b)
// pass (a): warps per block, 16 query rows each, sharing 16-key tiles
constexpr int Q_WARPS = 2;
constexpr int Q_ROWS = 16 * Q_WARPS;  // query rows per pass-(a) block (one rel-table partial)
constexpr int BKT = 16;               // keys per streamed tile of pass (a)

// Pass (b) at DP = 128 also splits the columns of dk and dv between two
// warps (all 128 columns of both spilled); both take the whole S and G.
template <int DP>
constexpr int KV_CSPLIT = DP == MAXD ? 2 : 1;

// Rows [row0, row0 + rows) of a [T, D] fp32 or bf16 tensor into a tile of
// row stride ld, zero past T. Columns D.. are not written (zeroed once at the
// start). vec: 16-byte cp.async (rows of whole 16-byte chunks, 16-byte
// aligned tensors); otherwise element by element.
template <typename T_>
__device__ __forceinline__ void stage_rows(T_* dst, const T_* __restrict__ src, int row0, int rows, int T,
                                           int D, int ld, bool vec, int tid, int nt) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T_);  // elements per 16-byte chunk
    const int cpr = D / EPC;
    for (int i = tid; i < rows * cpr; i += nt) {
      const int r = i / cpr, c = (i - r * cpr) * EPC;
      const int t = row0 + r;
      cp_async16(dst + r * ld + c, src + (size_t)(t < T ? t : 0) * D + c, t < T);
    }
  } else {
    for (int i = tid; i < rows * D; i += nt) {
      const int r = i / D, c = i - r * D;
      const int t = row0 + r;
      dst[r * ld + c] = t < T ? src[(size_t)t * D + c] : from_f<T_>(0.f);
    }
  }
}

// Tile `it` of a stream double buffered in stages of `stage` elements: tile
// it + 1 is loaded (`load(tile, dst)`) while tile it is computed. Returns
// tile it's stage, complete for every thread.
template <typename T_, typename F>
__device__ __forceinline__ T_* next_stage(T_* stages, int stage, int it, int ntiles, F load) {
  if (it + 1 < ntiles) load(it + 1, stages + ((it + 1) & 1) * stage);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  return stages + (it & 1) * stage;
}

// The tf32 A fragment (hi, lo) of 16 rows x 8 columns at a, row stride ld.
// K1 order (rel_attention.cu's S): tf32 column t <-> column 2t, t + 4 <->
// 2t + 1, by 8-byte loads; otherwise the columns in order, by 4-byte loads.
template <bool K1_ORDER>
__device__ __forceinline__ void a_frag(const float* a, int ld, int g, int tq, uint32_t hi[4], uint32_t lo[4]) {
  if constexpr (K1_ORDER) {
    const float2 x = *reinterpret_cast<const float2*>(a + g * ld + 2 * tq);
    const float2 y = *reinterpret_cast<const float2*>(a + (g + 8) * ld + 2 * tq);
    split(x.x, hi[0], lo[0]);
    split(y.x, hi[1], lo[1]);
    split(x.y, hi[2], lo[2]);
    split(y.y, hi[3], lo[3]);
  } else {
    const float* p = a + g * ld + tq;
    split(p[0], hi[0], lo[0]);
    split(p[8 * ld], hi[1], lo[1]);
    split(p[4], hi[2], lo[2]);
    split(p[8 * ld + 4], hi[3], lo[3]);
  }
}

// The two B values of an 8-deep step whose columns are rows of b: row g,
// in the order of a_frag
template <bool K1_ORDER>
__device__ __forceinline__ float2 b_pair(const float* b, int ld, int g, int tq) {
  if constexpr (K1_ORDER) return *reinterpret_cast<const float2*>(b + g * ld + 2 * tq);
  return make_float2(b[g * ld + tq], b[g * ld + tq + 4]);
}

// S and G of one 16 x 16 tile in one loop, as independent chains: s[j] +=
// a1 . b1^T and gt[j] += a2 . b2^T over DP (a: 16 rows, b: 16 rows, stride ld)
template <int DP, bool K1_ORDER>
__device__ __forceinline__ void sg_products(const float* a1, const float* b1, const float* a2, const float* b2,
                                            int ld, int g, int tq, float s[2][4], float gt[2][4]) {
#pragma unroll 1
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t h1[4], l1[4], h2[4], l2[4];
    a_frag<K1_ORDER>(a1 + kk * 8, ld, g, tq, h1, l1);
    a_frag<K1_ORDER>(a2 + kk * 8, ld, g, tq, h2, l2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 x = b_pair<K1_ORDER>(b1 + j * 8 * ld + kk * 8, ld, g, tq);
      const float2 y = b_pair<K1_ORDER>(b2 + j * 8 * ld + kk * 8, ld, g, tq);
      mma_3xtf32_step(s[j], h1, l1, x.x, x.y);
      mma_3xtf32_step(gt[j], h2, l2, y.x, y.y);
    }
  }
}

// acc[n] += c . b over one 8-deep step, 3xTF32: c a C tile in registers,
// whose columns are the step (A column tq <-> C column 2tq, tq + 4 <-> 2tq +
// 1: the C layout as it is, no shuffle); b the step's row 2tq, column g
template <int NN>
__device__ __forceinline__ void c_tile_times_rows(float acc[NN][4], const float c[4], const float* b, int ld) {
  uint32_t ah[4], al[4];
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_3xtf32_step(acc[n], ah, al, b[n * 8], b[ld + n * 8]);
}

// Pass (b)'s shared memory, in floats. Rows padded by 4 words: every
// fragment load (4-byte, rows g or 2tq apart) hits 32 different banks.
template <int DP>
struct KvTile {
  static constexpr int LD = DP + 4;
  static constexpr int KV = KV_KEYS * LD;    // K or V, resident
  static constexpr int STAGE = 2 * QT * LD;  // one q + dout tile
  static constexpr int CS = KV_CSPLIT<DP>, NN = DP / 8 / CS;  // column split; 8-column tiles a warp sums
  static constexpr int WARPS = KV_GROUPS * KV_QSPLIT * CS;
  static constexpr size_t BYTES = (2 * (size_t)KV + 2 * (size_t)STAGE) * sizeof(float);
  static_assert(2 * STAGE >= 2 * KV_GROUPS * CS * (KV_QSPLIT - 1) * NN * 128,
                "the stages hold the partial sums of dk and dv");
};

// Pass (b), fp32: dk and dv. Each 16 keys of the block are owned by
// KV_QSPLIT warps (at DP = 128 twice as many, each summing half the
// columns), each taking 16 rows of every query tile; the tiles stream through
// shared memory by cp.async, double buffered. Per tile: S^T = K . q^T and
// G^T = V . dout^T (K and V the A operands), then p, pt and ds in registers
// (C layout: rows are keys, columns queries), which are the A operands of
// dv += pt^T . dout and dk += ds^T . q as they are. The warps of one key
// group add their sums at the end, in shared memory, in a fixed order.
template <int DP>
__global__ void __launch_bounds__(32 * KvTile<DP>::WARPS, 1) bwd_kv_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ kmask, const float* __restrict__ dmask, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec, const float* __restrict__ band,
    float* __restrict__ dk, float* __restrict__ dv, int T, int D, int window, int causal, int skip_upper,
    int vec) {
  using L = KvTile<DP>;
  constexpr int LD = L::LD, CS = L::CS, NN = L::NN, NTH = 32 * L::WARPS;
  extern __shared__ __align__(16) float smf[];
  float* sk = smf;
  float* sv = sk + L::KV;
  float* stages = sv + L::KV;  // 2 x (q [QT][LD], dout [QT][LD])
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int cs = warp % CS, qs = (warp / CS) % KV_QSPLIT, kg = warp / (CS * KV_QSPLIT);
  const int kr = 16 * kg;         // this warp's first key row in the block
  const int c0 = cs * (DP / CS);  // its first column of dk and dv
  const int bh = blockIdx.y, k0 = blockIdx.x * KV_KEYS;
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const size_t base = (size_t)bh * T * D;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;
  bool key_in[2], key_masked[2];  // keys k0 + kr + g and + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int u = k0 + kr + g + 8 * r;
    key_in[r] = u < T;
    key_masked[r] = kmask && u < T && !(kmask[(size_t)bh * T + u] > 0.f);
  }

  for (int i = tid; i < 2 * L::KV + 2 * L::STAGE; i += NTH) smf[i] = 0.f;  // pad columns
  __syncthreads();
  stage_rows(sk, k + base, k0, KV_KEYS, T, D, LD, vec, tid, NTH);
  stage_rows(sv, v + base, k0, KV_KEYS, T, D, LD, vec, tid, NTH);
  const int q_begin = skip_upper ? (k0 / QT) * QT : 0;  // causal: no query above the first key sees it
  const int ntiles = (T - q_begin + QT - 1) / QT;
  auto load = [&](int tile, float* dst) {
    stage_rows(dst, q + base, q_begin + tile * QT, QT, T, D, LD, vec, tid, NTH);
    stage_rows(dst + QT * LD, dout + base, q_begin + tile * QT, QT, T, D, LD, vec, tid, NTH);
  };
  load(0, stages);
  cp_async_commit();

  float adk[NN][4], adv[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const float* sq = next_stage(stages, L::STAGE, it, ntiles, load) + 16 * qs * LD;
    const float* sdo = sq + QT * LD;
    const int q0 = q_begin + it * QT + 16 * qs;  // this warp's first query
    if (!skip_upper || k0 + kr <= q0 + 15) {      // else every p of this warp's tile is 0
      // thread holds keys k0 + kr + g (e = 0, 1) and + 8 (e = 2, 3), queries
      // q0 + 8j + 2tq + (e & 1); the per-query values and the dropout mask
      // first, so that their loads pass under the products
      float l_q[2][2], d_q[2][2], dmr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = q0 + j * 8 + 2 * tq + h;
          const bool tin = t < T;
          l_q[j][h] = tin ? lse[(size_t)bh * T + t] : 0.f;
          d_q[j][h] = tin ? dvec[(size_t)bh * T + t] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            dmr[j][2 * r + h] = dm && tin && key_in[r] ? dm[(size_t)t * T + k0 + kr + g + 8 * r] : 1.f;
        }
      float s[2][4], gt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = gt[j][e] = 0.f;
      sg_products<DP, false>(sk + kr * LD, sq, sv + kr * LD, sdo, LD, g, tq, s, gt);  // S^T, G^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // s <- pt, gt <- ds (0 outside the sequence)
          const int h = e & 1, r = e >> 1;
          const int t = q0 + j * 8 + 2 * tq + h, u = k0 + kr + g + 8 * r;
          float pt = 0.f, ds = 0.f;
          if (t < T && key_in[r]) {
            const int off = u - t;
            float x = s[j][e], gv = gt[j][e];
            if (win && off >= -window && off <= window) {
              const float* row = band + ((size_t)bh * T + t) * 2 * win;
              x += row[off + window];
              gv += row[win + off + window];
            }
            if ((causal && off > 0) || key_masked[r]) x = NEG;
            const float p = expf(x - l_q[j][h]);
            pt = p * dmr[j][e];
            // as pass (a); but S^T here is not K1's arithmetic (K is the A
            // operand), so a one-key row's p may miss 1 by an ulp and keep
            // g - D's rounding noise: exact zeroing holds for dq only
            if (p != 1.f) ds = p * (gv * dmr[j][e] - d_q[j][h]);
          }
          s[j][e] = pt;
          gt[j][e] = ds;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c_tile_times_rows<NN>(adv, s[j], sdo + (j * 8 + 2 * tq) * LD + c0 + g, LD);  // dv += pt^T . dout
        c_tile_times_rows<NN>(adk, gt[j], sq + (j * 8 + 2 * tq) * LD + c0 + g, LD);  // dk += ds^T . q
      }
    }
    __syncthreads();  // this stage is read: it may be refilled
  }

  // the warps with qs > 0 park their sums in the stages (lane-major, no bank
  // conflicts), the warp with qs = 0 adds them and stores
  constexpr int PARK = 2 * NN * 4 * 32;  // floats a warp parks
  float* park = stages + (size_t)(kg * CS + cs) * (KV_QSPLIT - 1) * PARK;
  if (qs > 0)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        park[(qs - 1) * PARK + (n * 4 + e) * 32 + lane] = adk[n][e];
        park[(qs - 1) * PARK + ((NN + n) * 4 + e) * 32 + lane] = adv[n][e];
      }
  __syncthreads();
  if (qs > 0) return;
  for (int o = 1; o < KV_QSPLIT; ++o) {
    const float* other = park + (o - 1) * PARK;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adk[n][e] += other[(n * 4 + e) * 32 + lane];
        adv[n][e] += other[((NN + n) * 4 + e) * 32 + lane];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int u = k0 + kr + g + 8 * r;
    if (u >= T) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + n * 8 + 2 * tq + h;
        if (c >= D) continue;
        dk[base + (size_t)u * D + c] = adk[n][2 * r + h];
        dv[base + (size_t)u * D + c] = adv[n][2 * r + h];
      }
  }
}

template <int DP>
int launch_kv_tf32(const float* q, const float* k, const float* v, const float* kmask, const float* dmask,
                   const float* dout, const float* lse, const float* dvec, const float* band, float* dk,
                   float* dv, int bh, int t, int d, int window, int causal, int skip_upper, cudaStream_t s) {
  using L = KvTile<DP>;
  cudaError_t e = cudaFuncSetAttribute(bwd_kv_tf32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
  bwd_kv_tf32<DP><<<dim3((t + KV_KEYS - 1) / KV_KEYS, bh), 32 * L::WARPS, L::BYTES, s>>>(
      q, k, v, kmask, dmask, dout, lse, dvec, band, dk, dv, t, d, window, causal, skip_upper, vec);
  return (int)cudaGetLastError();
}

// Pass (a)'s shared memory, in floats: q and dout resident, K and V tiles
// double buffered, rows padded by 8 words (K1's layout: the 8-byte fragment
// loads of S and G are free of bank conflicts; dq's B loads, rows 2tq
// apart, meet 2-way conflicts); then the fp32 band tables.
template <int DP>
struct QTile {
  static constexpr int LD = DP + 8;
  static constexpr int ROWS = Q_ROWS * LD;   // q or dout
  static constexpr int STAGE = 2 * BKT * LD;  // one K + V tile
  static constexpr int TILES = 2 * ROWS + 2 * STAGE;
  static size_t bytes(int win, int d) {
    return sizeof(float) * ((size_t)TILES + 2 * (size_t)win * d + 4 * (size_t)Q_ROWS * win);
  }
};

// Pass (a), fp32: dq, D, the band tables for pass (b) and the rel-table
// partials. A warp owns 16 query rows; the block's warps share the key
// tiles, streamed through shared memory by cp.async, double buffered. Per
// tile: S = q . K^T and G = dout . V^T, then ds in registers, whose C tile is
// the A operand of dq += ds . K. S is K1's to the bit, so on a row with one
// key p = exp(s - lse) is 1 (see the top).
template <int DP>
__global__ void __launch_bounds__(32 * Q_WARPS, 1) bwd_q_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rel_k, const float* __restrict__ rel_v, const float* __restrict__ kmask,
    const float* __restrict__ dmask, const float* __restrict__ out, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ dvec, float* __restrict__ band,
    float* __restrict__ drel_part, int T, int D, int window, int causal, int skip_upper, int vec) {
  using L = QTile<DP>;
  constexpr int LD = L::LD, NN = DP / 8, NTH = 32 * Q_WARPS;
  extern __shared__ __align__(16) float smf[];
  const int win = window >= 0 ? 2 * window + 1 : 0;
  float* sq = smf;                    // [Q_ROWS][LD]
  float* sdo = sq + L::ROWS;          // [Q_ROWS][LD]
  float* stages = sdo + L::ROWS;      // 2 x (K [BKT][LD], V [BKT][LD])
  float* srk = smf + L::TILES;        // [win][D]
  float* srv = srk + win * D;         // [win][D]
  float* srl = srv + win * D;         // [Q_ROWS][win] q . rel_k
  float* sgr = srl + Q_ROWS * win;    // [Q_ROWS][win] dout . rel_v
  float* sdsb = sgr + Q_ROWS * win;   // [Q_ROWS][win] band of ds
  float* sptb = sdsb + Q_ROWS * win;  // [Q_ROWS][win] band of pt
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qr = 16 * (tid >> 5);  // this warp's first row in the block
  const int bh = blockIdx.y, q0 = blockIdx.x * Q_ROWS;
  const size_t base = (size_t)bh * T * D;
  const float* km = kmask ? kmask + (size_t)bh * T : nullptr;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;

  for (int i = tid; i < L::TILES; i += NTH) smf[i] = 0.f;  // pad columns
  for (int i = tid; i < Q_ROWS * win; i += NTH) sdsb[i] = sptb[i] = 0.f;
  for (int i = tid; i < win * D; i += NTH) {
    srk[i] = rel_k[i];
    srv[i] = rel_v[i];
  }
  __syncthreads();
  stage_rows(sq, q + base, q0, Q_ROWS, T, D, LD, vec, tid, NTH);
  stage_rows(sdo, dout + base, q0, Q_ROWS, T, D, LD, vec, tid, NTH);
  cp_async_commit();
  const int k_end = skip_upper ? min(T, q0 + Q_ROWS) : T;  // causal: no key past the block's last row
  const int ntiles = (k_end + BKT - 1) / BKT;
  auto load = [&](int tile, float* dst) {
    stage_rows(dst, k + base, tile * BKT, BKT, T, D, LD, vec, tid, NTH);
    stage_rows(dst + BKT * LD, v + base, tile * BKT, BKT, T, D, LD, vec, tid, NTH);
  };
  load(0, stages);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // q and dout are in
  for (int i = tid; i < Q_ROWS * win; i += NTH) {  // the band products, fp32 FMA as K1 takes q . rel_k
    const int r = i / win, o = i - r * win;
    float a = 0.f, b = 0.f;
    for (int c = 0; c < D; ++c) {
      a = fmaf(sq[r * LD + c], srk[o * D + c], a);
      b = fmaf(sdo[r * LD + c], srv[o * D + c], b);
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
  float l_r[2], d_r[2];  // rows qr + g and + 8: LSE and D = dout . out (a quad's 4 threads a row)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qr + g + 8 * h, t = q0 + r;
    l_r[h] = t < T ? lse[(size_t)bh * T + t] : 0.f;
    float a = 0.f;
    if (t < T)
      for (int c = tq; c < D; c += 4) a = fmaf(sdo[r * LD + c], out[base + (size_t)t * D + c], a);
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    d_r[h] = a + __shfl_xor_sync(0xffffffffu, a, 2);
    if (tq == 0 && t < T) dvec[(size_t)bh * T + t] = d_r[h];
  }
  __syncthreads();  // srl and sgr are in

  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const float* sk = next_stage(stages, L::STAGE, it, ntiles, load);
    const float* sv = sk + BKT * LD;
    const int k0 = it * BKT;
    if (!skip_upper || k0 <= q0 + qr + 15) {  // else every p of this warp's tile is 0
      // thread holds rows qr + g (e = 0, 1) and + 8 (e = 2, 3), keys k0 + 8j
      // + 2tq + (e & 1); the dropout and key mask first, under the products
      float dmr[2][4];
      bool masked[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = q0 + qr + g + 8 * (e >> 1), u = k0 + j * 8 + 2 * tq + (e & 1);
          dmr[j][e] = dm && t < T && u < T ? dm[(size_t)t * T + u] : 1.f;
          if (e < 2) masked[j][e] = km && u < T && !(km[u] > 0.f);
        }
      float s[2][4], gt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = gt[j][e] = 0.f;
      sg_products<DP, true>(sq + qr * LD, sk, sdo + qr * LD, sv, LD, g, tq, s, gt);  // S, G
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // gt <- ds (0 outside the sequence)
          const int h = e >> 1, r = qr + g + 8 * h, t = q0 + r;
          const int u = k0 + j * 8 + 2 * tq + (e & 1);
          float ds = 0.f;
          if (t < T && u < T) {
            const int off = u - t;
            const bool in_band = win && off >= -window && off <= window;
            float x = s[j][e], gv = gt[j][e];
            if (in_band) {
              x += srl[r * win + off + window];
              gv += sgr[r * win + off + window];
            }
            if ((causal && off > 0) || masked[j][e & 1]) x = NEG;
            const float p = expf(x - l_r[h]);
            if (p != 1.f) ds = p * (gv * dmr[j][e] - d_r[h]);  // p = 1: the row's one key, ds = 0
            if (in_band) {  // each (row, diagonal) has one owner
              sdsb[r * win + off + window] = ds;
              sptb[r * win + off + window] = p * dmr[j][e];
            }
          }
          gt[j][e] = ds;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) c_tile_times_rows<NN>(acc, gt[j], sk + (j * 8 + 2 * tq) * LD + g, LD);
    }
    __syncthreads();  // this stage is read: it may be refilled
  }

  // dq = ds . k + band(ds) . rel_k; thread holds rows qr + g + 8 (e >> 1),
  // columns 8n + 2tq + (e & 1)
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qr + g + 8 * (e >> 1), t = q0 + r;
      const int c = n * 8 + 2 * tq + (e & 1);
      if (t >= T || c >= D) continue;
      float o = acc[n][e];
      for (int ow = 0; ow < win; ++ow) o = fmaf(sdsb[r * win + ow], srk[ow * D + c], o);
      dq[base + (size_t)t * D + c] = o;
    }
  if (win) {
    float* part = drel_part + ((size_t)bh * gridDim.x + blockIdx.x) * 2 * win * D;
    for (int i = tid; i < win * D; i += NTH) {
      const int o = i / D, c = i - o * D;
      float a = 0.f, b = 0.f;
      for (int r = 0; r < Q_ROWS; ++r) {  // rows past T hold zeros
        a = fmaf(sdsb[r * win + o], sq[r * LD + c], a);
        b = fmaf(sptb[r * win + o], sdo[r * LD + c], b);
      }
      part[i] = a;
      part[win * D + i] = b;
    }
  }
}

template <int DP>
int launch_q_tf32(const float* q, const float* k, const float* v, const float* rel_k, const float* rel_v,
                  const float* kmask, const float* dmask, const float* out, const float* dout, const float* lse,
                  float* dq, float* dvec, float* band, float* drel_part, int bh, int t, int d, int window,
                  int causal, int skip_upper, cudaStream_t s) {
  const size_t smem = QTile<DP>::bytes(window >= 0 ? 2 * window + 1 : 0, d);
  cudaError_t e = cudaFuncSetAttribute(bwd_q_tf32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
  bwd_q_tf32<DP><<<dim3((t + Q_ROWS - 1) / Q_ROWS, bh), 32 * Q_WARPS, smem, s>>>(
      q, k, v, rel_k, rel_v, kmask, dmask, out, dout, lse, dq, dvec, band, drel_part, t, d, window, causal,
      skip_upper, vec);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores: mma.sync.m16n8k16 bf16, fp32 sums ----

// A block of either pass owns 16 rows (pass (a): query rows; pass (b):
// keys) and streams the other side in tiles of BF_TILE rows, double
// buffered; each of its BF_WARPS warps (times the column split in pass (b))
// takes 16 rows of every tile.
constexpr int BF_WARPS = 4;
constexpr int BF_TILE = 16 * BF_WARPS;
// Blocks of 128 threads an SM holds (pass (b) at DP = 128: half as many of
// 256), which caps a thread at 168 registers: at DP = 96 and T 512 each
// pass's 384 blocks then run in one wave on 132 SMs, not 1.45 (0.133 ms of
// device time against 0.210 on an H100; the cap costs no spill)
constexpr int BF_BLOCKS_PER_SM = 3;

// Shared memory of both passes, bf16 rows of DP + 8 elements: 16-byte
// aligned for cp.async and ldmatrix, and an odd number of 16-byte chunks, so
// that the 8 rows an ldmatrix phase reads hit 8 different bank groups.
template <int DP>
struct Bf16Tile {
  static constexpr int LD = DP + 8;
  static constexpr int ROWS = 16 * LD;            // the 16 resident rows of one tensor
  static constexpr int STAGE = 2 * BF_TILE * LD;  // one streamed tile of two tensors
  static constexpr size_t BYTES = sizeof(bf16) * (2 * (size_t)ROWS + 2 * (size_t)STAGE);
  // pass (a) adds the fp32 band tables and each warp's part of D
  static size_t bytes_q(int win, int d) {
    return BYTES + sizeof(float) * (2 * (size_t)win * d + 4 * 16 * (size_t)win + BF_WARPS * 16);
  }
  // the stages hold pass (a)'s dq and pass (b)'s dk and dv partial sums at the end
  static_assert(2 * STAGE * sizeof(bf16) >= BF_WARPS * 16 * DP * sizeof(float), "dq partials fit");
  static_assert(2 * STAGE * sizeof(bf16) >= (BF_WARPS - 1) * 2 * DP * 16 * sizeof(float), "dk, dv partials fit");
};

// The ldmatrix address of lane `lane` for 16 rows x 16 columns (16 c..) of a
// tile of row stride ld. By ldsm_x4, the A fragment of those rows; by
// ldsm_x4_t, the B fragments of two n8 tiles (columns 16 c.. and 16 c + 8..)
// with the rows as k.
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int ld, int c, int lane) {
  return tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + c * 16 + (lane >> 4) * 8;
}
// By ldsm_x4, the B fragments of two n8 tiles whose columns are rows 0-7 and
// 8-15 of the tile, with its columns 16 c.. as k
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int ld, int c, int lane) {
  return tile + ((lane & 7) + (lane >> 4) * 8) * ld + c * 16 + ((lane >> 3) & 1) * 8;
}

// S and G of one 16 x 16 tile as independent chains over DP: s += a1 . b1^T
// and g += a2 . b2^T, afrag(kk, a1, a2) giving the A fragments of step kk,
// b1 and b2 tiles whose 16 rows are the columns
template <int DP, typename FA>
__device__ __forceinline__ void sg_bf16(FA afrag, const bf16* b1, const bf16* b2, int ld, int lane,
                                        float s[2][4], float g[2][4]) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a1[4], a2[4], x[4], y[4];
    afrag(kk, a1, a2);
    ldsm_x4(x, frag_b(b1, ld, kk, lane));
    ldsm_x4(y, frag_b(b2, ld, kk, lane));
    mma_bf16(s[0], a1, x[0], x[1]);
    mma_bf16(s[1], a1, x[2], x[3]);
    mma_bf16(g[0], a2, y[0], y[1]);
    mma_bf16(g[1], a2, y[2], y[3]);
  }
}

// Two adjacent m16n8 C tiles as one m16n8k16 A fragment, rounded to bf16
// (rel_attention.cu packs P so)
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// acc[2m], acc[2m + 1] += a . b over m = 0 .. NM - 1: a the A fragment whose
// k are the 16 rows of tile b, b's columns 16 (c0 + m).. the n, by
// ldmatrix.trans
template <int NM>
__device__ __forceinline__ void a_times_rows(float acc[][4], const uint32_t a[4], const bf16* b, int ld, int c0,
                                             int lane) {
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    uint32_t x[4];
    ldsm_x4_t(x, frag_a(b, ld, c0 + m, lane));
    mma_bf16(acc[2 * m], a, x[0], x[1]);
    mma_bf16(acc[2 * m + 1], a, x[2], x[3]);
  }
}

// Pass (a), bf16: dq, D, the band tables for pass (b) and the rel-table
// partials. The block's 16 query rows are shared by its BF_WARPS warps, each
// taking 16 keys of every streamed K and V tile. Two sweeps over the keys
// run the same instructions (one loop body): the first sums D = sum_u g p per
// row (each warp its part, added in a fixed order), the second takes ds = p
// (g - D) and dq += ds . K; the warps' dq are added in a fixed order at the
// end. S = q . K^T and G = dout . V^T take q and dout as A fragments (held in
// registers up to DP = 96), K and V as B fragments by ldmatrix; two C tiles
// of ds are one A fragment of dq += ds . K, K through ldmatrix.trans.
template <int DP>
__global__ void __launch_bounds__(32 * BF_WARPS, BF_BLOCKS_PER_SM) bwd_q_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rel_k, const bf16* __restrict__ rel_v, const float* __restrict__ kmask,
    const float* __restrict__ dmask, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ dvec, float* __restrict__ band, float* __restrict__ drel_part,
    int T, int D, int window, int causal, int skip_upper, int vec) {
  using L = Bf16Tile<DP>;
  constexpr int LD = L::LD, KS = DP / 16, NN = DP / 8, NTH = 32 * BF_WARPS;
  constexpr bool HOLD = DP <= 96;  // q's and dout's A fragments in registers (64 more at DP 128)
  extern __shared__ __align__(16) unsigned char smb[];
  const int win = window >= 0 ? 2 * window + 1 : 0;
  bf16* sq = reinterpret_cast<bf16*>(smb);  // [16][LD]
  bf16* sdo = sq + L::ROWS;                  // [16][LD]
  bf16* stages = sdo + L::ROWS;              // 2 x (K [BF_TILE][LD], V [BF_TILE][LD])
  float* srk = reinterpret_cast<float*>(smb + L::BYTES);  // [win][D]
  float* srv = srk + win * D;                              // [win][D]
  float* srl = srv + win * D;                              // [16][win] q . rel_k
  float* sgr = srl + 16 * win;                             // [16][win] dout . rel_v
  float* sdsb = sgr + 16 * win;                            // [16][win] band of ds (bf16 values)
  float* sptb = sdsb + 16 * win;                           // [16][win] band of pt (bf16 values)
  float* s_d = sptb + 16 * win;                            // [BF_WARPS][16] each warp's part of D
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * 16;
  const size_t base = (size_t)bh * T * D;
  const float* km = kmask ? kmask + (size_t)bh * T : nullptr;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;

  for (int i = tid; i < (int)(L::BYTES / 16); i += NTH) reinterpret_cast<uint4*>(smb)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 16 * win; i += NTH) sdsb[i] = sptb[i] = 0.f;
  for (int i = tid; i < win * D; i += NTH) {
    srk[i] = to_f(rel_k[i]);
    srv[i] = to_f(rel_v[i]);
  }
  __syncthreads();
  stage_rows(sq, q + base, q0, 16, T, D, LD, vec, tid, NTH);
  stage_rows(sdo, dout + base, q0, 16, T, D, LD, vec, tid, NTH);
  cp_async_commit();
  const int k_end = skip_upper ? min(T, q0 + 16) : T;  // causal: no key past the block's last row
  const int ntiles = (k_end + BF_TILE - 1) / BF_TILE;
  auto load = [&](int tile, bf16* dst) {
    stage_rows(dst, k + base, tile * BF_TILE, BF_TILE, T, D, LD, vec, tid, NTH);
    stage_rows(dst + BF_TILE * LD, v + base, tile * BF_TILE, BF_TILE, T, D, LD, vec, tid, NTH);
  };
  load(0, stages);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // q and dout are in
  for (int i = tid; i < 16 * win; i += NTH) {  // the band products, fp32 FMA as K1 takes q . rel_k
    const int r = i / win, o = i - r * win;
    float a = 0.f, b = 0.f;
    for (int c = 0; c < D; ++c) {
      a = fmaf(to_f(sq[r * LD + c]), srk[o * D + c], a);
      b = fmaf(to_f(sdo[r * LD + c]), srv[o * D + c], b);
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
  float l_r[2];  // rows g and g + 8: the LSE
#pragma unroll
  for (int h = 0; h < 2; ++h) l_r[h] = q0 + g + 8 * h < T ? lse[(size_t)bh * T + q0 + g + 8 * h] : 0.f;
  uint32_t qf[HOLD ? KS : 1][4], df[HOLD ? KS : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(qf[kk], frag_a(sq, LD, kk, lane));
      ldsm_x4(df[kk], frag_a(sdo, LD, kk, lane));
    }
  }
  auto afrag = [&](int kk, uint32_t* a1, uint32_t* a2) {
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = qf[kk][i];
        a2[i] = df[kk][i];
      }
    } else {
      ldsm_x4(a1, frag_a(sq, LD, kk, lane));
      ldsm_x4(a2, frag_a(sdo, LD, kk, lane));
    }
  };
  __syncthreads();  // srl and sgr are in

  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float dsum[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};

  // sweep 0 sums D, sweep 1 takes ds and dq: one loop body, so that S, G, p
  // and g dm are the same instructions in both, and g dm - D is exactly 0
  // where p = 1 is a row's only weight
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int it = 0; it < ntiles; ++it) {
      const bf16* sk = next_stage(stages, L::STAGE, it, ntiles, load) + 16 * warp * LD;
      const bf16* sv = sk + BF_TILE * LD;
      const int k0 = it * BF_TILE + 16 * warp;  // this warp's first key
      if (!skip_upper || k0 <= q0 + 15) {       // else every p of this warp's keys is 0
        // thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3), keys k0 + 8j
        // + 2tq + (e & 1); the dropout and key mask first, under the products
        float dmr[2][4];
        bool masked[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = q0 + g + 8 * (e >> 1), u = k0 + j * 8 + 2 * tq + (e & 1);
            dmr[j][e] = dm && t < T && u < T ? dm[(size_t)t * T + u] : 1.f;
            if (e < 2) masked[j][e] = km && u < T && !(km[u] > 0.f);
          }
        float s[2][4], gt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = gt[j][e] = 0.f;
        sg_bf16<DP>(afrag, sk, sv, LD, lane, s, gt);  // S, G
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // s <- p (bf16), gt <- g dm (0 outside the sequence)
            const int h = e >> 1, r = g + 8 * h, t = q0 + r;
            const int u = k0 + j * 8 + 2 * tq + (e & 1), off = u - t;
            float p = 0.f, gd = 0.f;
            if (t < T && u < T) {
              float x = s[j][e], gv = gt[j][e];
              if (win && off >= -window && off <= window) {
                x += srl[r * win + off + window];
                gv += sgr[r * win + off + window];
              }
              if ((causal && off > 0) || masked[j][e & 1]) x = NEG;
              p = round_to<bf16>(expf(x - l_r[h]));  // the TPU kernel's p_lo
              gd = __fmul_rn(gv, dmr[j][e]);         // never fused into g dm - D below
            }
            s[j][e] = p;
            gt[j][e] = gd;
          }
        if (sweep == 0) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dsum[e >> 1] = fmaf(gt[j][e], s[j][e], dsum[e >> 1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // gt <- ds; the bands of ds and pt, rounded as products take them
              const int h = e >> 1, r = g + 8 * h;
              const int off = k0 + j * 8 + 2 * tq + (e & 1) - (q0 + r);
              const float ds = s[j][e] * (gt[j][e] - d_r[h]);
              if (win && off >= -window && off <= window && q0 + r < T) {  // each (row, diagonal) has one owner
                sdsb[r * win + off + window] = round_to<bf16>(ds);
                sptb[r * win + off + window] = round_to<bf16>(s[j][e] * dmr[j][e]);
              }
              gt[j][e] = ds;
            }
          uint32_t a[4];
          pack_a(a, gt);
          a_times_rows<KS>(acc, a, sk, LD, 0, lane);  // dq += ds . K
        }
      }
      __syncthreads();  // this stage is read: it may be refilled
    }
    if (sweep == 0) {  // D: the warps' parts in a fixed order; then the keys again from tile 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
        dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
        if (tq == 0) s_d[warp * 16 + g + 8 * h] = dsum[h];
      }
      load(0, stages);
      cp_async_commit();
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = q0 + g + 8 * h;
        for (int w = 0; w < BF_WARPS; ++w) d_r[h] += s_d[w * 16 + g + 8 * h];
        if (warp == 0 && tq == 0 && t < T) dvec[(size_t)bh * T + t] = d_r[h];
      }
    }
  }
  cp_async_wait<0>();

  // dq = ds . k + band(ds) . rel_k: the warps' sums parked in the stages,
  // added in a fixed order
  float* park = reinterpret_cast<float*>(stages);  // [BF_WARPS][16][DP]
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    float* w = park + warp * 16 * DP + n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(w + g * DP) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(w + (g + 8) * DP) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  for (int i = tid; i < 16 * D; i += NTH) {
    const int r = i / D, c = i - r * D, t = q0 + r;
    if (t >= T) continue;
    float o = 0.f;
    for (int w = 0; w < BF_WARPS; ++w) o += park[(w * 16 + r) * DP + c];
    for (int ow = 0; ow < win; ++ow) o = fmaf(sdsb[r * win + ow], srk[ow * D + c], o);
    dq[base + (size_t)t * D + c] = from_f<bf16>(o);
  }
  if (win) {
    float* part = drel_part + ((size_t)bh * gridDim.x + blockIdx.x) * 2 * win * D;
    for (int i = tid; i < win * D; i += NTH) {
      const int o = i / D, c = i - o * D;
      float a = 0.f, b = 0.f;
      for (int r = 0; r < 16; ++r) {  // rows past T hold zeros
        a = fmaf(sdsb[r * win + o], to_f(sq[r * LD + c]), a);
        b = fmaf(sptb[r * win + o], to_f(sdo[r * LD + c]), b);
      }
      part[i] = a;
      part[win * D + i] = b;
    }
  }
}

// Pass (b), bf16: dk and dv. The block's 16 keys are shared by its warps,
// each taking 16 rows of every streamed q and dout tile (at DP = 128 twice
// as many warps, each summing half the columns of dk and dv). Per tile: S^T
// = K . q^T and G^T = V . dout^T (K and V the A operands, by ldmatrix from
// shared memory), then p, pt and ds in registers, whose C tiles (rows keys,
// columns queries) pack into the A fragments of dv += pt^T . dout and dk +=
// ds^T . q, dout and q through ldmatrix.trans. The warps' sums are added in
// shared memory at the end, in a fixed order.
template <int DP>
__global__ void __launch_bounds__(32 * BF_WARPS * KV_CSPLIT<DP>, BF_BLOCKS_PER_SM / KV_CSPLIT<DP>) bwd_kv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kmask, const float* __restrict__ dmask, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec, const float* __restrict__ band,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int D, int window, int causal, int skip_upper,
    int vec) {
  using L = Bf16Tile<DP>;
  constexpr int LD = L::LD, CS = KV_CSPLIT<DP>, NN = DP / 8 / CS, NTH = 32 * BF_WARPS * CS;
  extern __shared__ __align__(16) unsigned char smb[];
  bf16* sk = reinterpret_cast<bf16*>(smb);  // [16][LD]
  bf16* sv = sk + L::ROWS;                   // [16][LD]
  bf16* stages = sv + L::ROWS;               // 2 x (q [BF_TILE][LD], dout [BF_TILE][LD])
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int cs = warp % CS, qs = warp / CS;
  const int c0 = cs * (DP / CS);  // this warp's first column of dk and dv
  const int bh = blockIdx.y, k0 = blockIdx.x * 16;
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const size_t base = (size_t)bh * T * D;
  const float* dm = dmask ? dmask + (size_t)bh * T * T : nullptr;
  bool key_in[2], key_masked[2];  // keys k0 + g and + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int u = k0 + g + 8 * r;
    key_in[r] = u < T;
    key_masked[r] = kmask && u < T && !(kmask[(size_t)bh * T + u] > 0.f);
  }

  for (int i = tid; i < (int)(L::BYTES / 16); i += NTH) reinterpret_cast<uint4*>(smb)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  stage_rows(sk, k + base, k0, 16, T, D, LD, vec, tid, NTH);
  stage_rows(sv, v + base, k0, 16, T, D, LD, vec, tid, NTH);
  const int q_begin = skip_upper ? (k0 / BF_TILE) * BF_TILE : 0;  // causal: no query above the first key sees it
  const int ntiles = (T - q_begin + BF_TILE - 1) / BF_TILE;
  auto load = [&](int tile, bf16* dst) {
    stage_rows(dst, q + base, q_begin + tile * BF_TILE, BF_TILE, T, D, LD, vec, tid, NTH);
    stage_rows(dst + BF_TILE * LD, dout + base, q_begin + tile * BF_TILE, BF_TILE, T, D, LD, vec, tid, NTH);
  };
  load(0, stages);
  cp_async_commit();
  auto afrag = [&](int kk, uint32_t* a1, uint32_t* a2) {
    ldsm_x4(a1, frag_a(sk, LD, kk, lane));
    ldsm_x4(a2, frag_a(sv, LD, kk, lane));
  };

  float adk[NN][4], adv[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const bf16* sq = next_stage(stages, L::STAGE, it, ntiles, load) + 16 * qs * LD;
    const bf16* sdo = sq + BF_TILE * LD;
    const int q0 = q_begin + it * BF_TILE + 16 * qs;  // this warp's first query
    if (!skip_upper || k0 <= q0 + 15) {                // else every p of this warp's tile is 0
      // thread holds keys k0 + g (e = 0, 1) and + 8 (e = 2, 3), queries q0 +
      // 8j + 2tq + (e & 1); the per-query values and the dropout mask first,
      // so that their loads pass under the products
      float l_q[2][2], d_q[2][2], dmr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = q0 + j * 8 + 2 * tq + h;
          const bool tin = t < T;
          l_q[j][h] = tin ? lse[(size_t)bh * T + t] : 0.f;
          d_q[j][h] = tin ? dvec[(size_t)bh * T + t] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            dmr[j][2 * r + h] = dm && tin && key_in[r] ? dm[(size_t)t * T + k0 + g + 8 * r] : 1.f;
        }
      float s[2][4], gt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = gt[j][e] = 0.f;
      sg_bf16<DP>(afrag, sq, sdo, LD, lane, s, gt);  // S^T, G^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // s <- pt, gt <- ds (0 outside the sequence); bf16 when packed
          const int h = e & 1, r = e >> 1;
          const int t = q0 + j * 8 + 2 * tq + h, u = k0 + g + 8 * r;
          float pt = 0.f, ds = 0.f;
          if (t < T && key_in[r]) {
            const int off = u - t;
            float x = s[j][e], gv = gt[j][e];
            if (win && off >= -window && off <= window) {
              const float* row = band + ((size_t)bh * T + t) * 2 * win;
              x += row[off + window];
              gv += row[win + off + window];
            }
            if ((causal && off > 0) || key_masked[r]) x = NEG;
            const float p = round_to<bf16>(expf(x - l_q[j][h]));
            pt = p * dmr[j][e];
            ds = p * (__fmul_rn(gv, dmr[j][e]) - d_q[j][h]);
          }
          s[j][e] = pt;
          gt[j][e] = ds;
        }
      uint32_t a[4];
      pack_a(a, s);
      a_times_rows<NN / 2>(adv, a, sdo, LD, c0 / 16, lane);  // dv += pt^T . dout
      pack_a(a, gt);
      a_times_rows<NN / 2>(adk, a, sq, LD, c0 / 16, lane);  // dk += ds^T . q
    }
    __syncthreads();  // this stage is read: it may be refilled
  }
  cp_async_wait<0>();

  // the warps with qs > 0 park their sums in the stages (lane-major, no bank
  // conflicts), the warp with qs = 0 adds them and stores
  constexpr int PARK = 2 * NN * 4 * 32;  // floats a warp parks
  float* park = reinterpret_cast<float*>(stages) + (size_t)cs * (BF_WARPS - 1) * PARK;
  if (qs > 0)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        park[(qs - 1) * PARK + (n * 4 + e) * 32 + lane] = adk[n][e];
        park[(qs - 1) * PARK + ((NN + n) * 4 + e) * 32 + lane] = adv[n][e];
      }
  __syncthreads();
  if (qs > 0) return;
  for (int o = 1; o < BF_WARPS; ++o) {
    const float* other = park + (o - 1) * PARK;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adk[n][e] += other[(n * 4 + e) * 32 + lane];
        adv[n][e] += other[((NN + n) * 4 + e) * 32 + lane];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int u = k0 + g + 8 * r;
    if (u >= T) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + n * 8 + 2 * tq + h;
        if (c >= D) continue;
        dk[base + (size_t)u * D + c] = from_f<bf16>(adk[n][2 * r + h]);
        dv[base + (size_t)u * D + c] = from_f<bf16>(adv[n][2 * r + h]);
      }
  }
}

template <int DP>
int launch_q_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* rel_k, const bf16* rel_v,
                  const float* kmask, const float* dmask, const bf16* dout, const float* lse, bf16* dq,
                  float* dvec, float* band, float* drel_part, int bh, int t, int d, int window, int causal,
                  int skip_upper, int vec, cudaStream_t s) {
  const size_t smem = Bf16Tile<DP>::bytes_q(window >= 0 ? 2 * window + 1 : 0, d);
  cudaError_t e = cudaFuncSetAttribute(bwd_q_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bwd_q_bf16<DP><<<dim3((t + 15) / 16, bh), 32 * BF_WARPS, smem, s>>>(
      q, k, v, rel_k, rel_v, kmask, dmask, dout, lse, dq, dvec, band, drel_part, t, d, window, causal, skip_upper,
      vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_kv_bf16(const bf16* q, const bf16* k, const bf16* v, const float* kmask, const float* dmask,
                   const bf16* dout, const float* lse, const float* dvec, const float* band, bf16* dk, bf16* dv,
                   int bh, int t, int d, int window, int causal, int skip_upper, int vec, cudaStream_t s) {
  constexpr size_t smem = Bf16Tile<DP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(bwd_kv_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bwd_kv_bf16<DP><<<dim3((t + 15) / 16, bh), 32 * BF_WARPS * KV_CSPLIT<DP>, smem, s>>>(
      q, k, v, kmask, dmask, dout, lse, dvec, band, dk, dv, t, d, window, causal, skip_upper, vec);
  return (int)cudaGetLastError();
}

// D zero-padded to the next of 32, 64, 96, 128, as in rel_attention.cu
template <template <int> class F, typename... A>
int by_dp(int d, A... a) {
  if (d <= 32) return F<32>::run(a...);
  if (d <= 64) return F<64>::run(a...);
  if (d <= 96) return F<96>::run(a...);
  return F<MAXD>::run(a...);
}
template <int DP>
struct Smem {  // (pass (a), pass (b)) bytes of each type
  static int run(int is_bf16, int win, int d, size_t* kv) {
    *kv = is_bf16 ? Bf16Tile<DP>::BYTES : KvTile<DP>::BYTES;
    return (int)(is_bf16 ? Bf16Tile<DP>::bytes_q(win, d) : QTile<DP>::bytes(win, d));
  }
};
template <int DP>
struct LaunchFp32 {
  static int run(const float* q, const float* k, const float* v, const float* rel_k, const float* rel_v,
                 const float* kmask, const float* dmask, const float* out, const float* dout, const float* lse,
                 float* dq, float* dk, float* dv, float* dvec, float* band, float* drel_part, int bh, int t,
                 int d, int window, int causal, int skip_upper, cudaStream_t s) {
    const int e = launch_q_tf32<DP>(q, k, v, rel_k, rel_v, kmask, dmask, out, dout, lse, dq, dvec, band,
                                    drel_part, bh, t, d, window, causal, skip_upper, s);
    if (e) return e;
    return launch_kv_tf32<DP>(q, k, v, kmask, dmask, dout, lse, dvec, band, dk, dv, bh, t, d, window, causal,
                              skip_upper, s);
  }
};
template <int DP>
struct LaunchBf16 {
  static int run(const bf16* q, const bf16* k, const bf16* v, const bf16* rel_k, const bf16* rel_v,
                 const float* kmask, const float* dmask, const bf16* dout, const float* lse, bf16* dq, bf16* dk,
                 bf16* dv, float* dvec, float* band, float* drel_part, int bh, int t, int d, int window,
                 int causal, int skip_upper, cudaStream_t s) {
    // 16-byte cp.async needs rows of whole 16-byte chunks and aligned tensors
    const int vec = d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
    const int e = launch_q_bf16<DP>(q, k, v, rel_k, rel_v, kmask, dmask, dout, lse, dq, dvec, band, drel_part,
                                    bh, t, d, window, causal, skip_upper, vec, s);
    if (e) return e;
    return launch_kv_bf16<DP>(q, k, v, kmask, dmask, dout, lse, dvec, band, dk, dv, bh, t, d, window, causal,
                              skip_upper, vec, s);
  }
};

}  // namespace

// is_bf16 = 0: q, k, v, rel_k, rel_v, out, dout, dq, dk and dv are float; 1:
// __nv_bfloat16 (out is then not read: D comes from the key sweep). Scratch
// from the caller: dvec [bh * t], band [bh * t * 2 (2w+1)] and drel_part
// [q_blocks * bh * 2 * (2w+1) * d] (both null without a window), fp32. The
// tiling is the caller's plan (ops/attention.py::bwd_plan): pass (a)'s
// blocks along T (one rel-table partial each), pass (b)'s, and the shared
// memory of each; a plan that is not this kernel's is refused.
extern "C" int sovits_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* rel_k, const void* rel_v,
    const float* kmask, const float* dmask, const void* out, const void* dout, const float* lse, void* dq,
    void* dk, void* dv, float* dvec, float* band, float* drel_part, int bh, int t, int d, int window,
    int causal, int is_bf16, int q_blocks, int kv_blocks, int smem_q, int smem_kv, void* stream) {
  if (d < 1 || d > MAXD || t < 1 || bh < 1) return (int)cudaErrorInvalidValue;
  if (window >= 0 && (!rel_k || !rel_v || !band || !drel_part)) return (int)cudaErrorInvalidValue;
  const int win = window >= 0 ? 2 * window + 1 : 0;
  const int skip_upper = causal && kmask == nullptr;
  size_t want_kv = 0;
  const size_t want_q = by_dp<Smem>(d, is_bf16, win, d, &want_kv);
  const int q_rows = is_bf16 ? 16 : Q_ROWS, kv_keys = is_bf16 ? 16 : KV_KEYS;
  if (q_blocks != (t + q_rows - 1) / q_rows || kv_blocks != (t + kv_keys - 1) / kv_keys ||
      (size_t)smem_q != want_q || (size_t)smem_kv != want_kv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return by_dp<LaunchBf16>(d, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel_k,
                             (const bf16*)rel_v, kmask, dmask, (const bf16*)dout, lse, (bf16*)dq, (bf16*)dk,
                             (bf16*)dv, dvec, band, drel_part, bh, t, d, window, causal, skip_upper, s);
  return by_dp<LaunchFp32>(d, (const float*)q, (const float*)k, (const float*)v, (const float*)rel_k,
                           (const float*)rel_v, kmask, dmask, (const float*)out, (const float*)dout, lse,
                           (float*)dq, (float*)dk, (float*)dv, dvec, band, drel_part, bh, t, d, window,
                           causal, skip_upper, s);
}

// Fused squared-L2 distance + top-k selection for Hopper (sm_90a).
//
// Replaces the two TPU kernels of mpi_knn_tpu/ops/pallas_knn.py:
//   fused_knn_tiles_kernel  <- fused_knn_tiles (_fused_knn_kernel): one CTA
//       per (query sub-tile, corpus tile); writes that corpus tile's k
//       survivors per query into an (n_c, Q, k) output.
//   fused_knn_sweep_kernel  <- fused_knn_sweep (_fused_knn_sweep_kernel):
//       one CTA per query sub-tile sweeps the WHOLE corpus in a loop inside
//       the block (the TPU ran that sweep as a sequential grid axis; blocks
//       on Hopper run in parallel and in no order) and writes the final
//       (Q, k) once.
// Each kernel differs from the other only in the corpus column range a CTA
// owns and where its output lands.
//
// Modes (the `compress` flag of the TPU kernels), both on knn_tile.cuh's
// tensor-core tile `sweep_mma`, 128 x 128 per CTA:
//   exact     (fused_knn_{tiles,sweep}_kernel, the Tf32x3 policy) the f32
//             rows split into tf32 hi + lo and multiplied in three passes
//             (lo.hi, hi.lo, hi.hi) with f32 sums, after the prologue
//             (stage_tf32_f32_launch) wrote the queries' and the corpus'
//             norms by the same product sequence, once per call. The
//             products are f32-accurate, as the zero-distance exclusion
//             threshold rtol 1e-6 * (q^2 + c^2) needs. Masks: padding
//             columns (>= m_corpus), zero distance (d <= zero_eps if > 0,
//             else d <= 1e-6 (q^2 + c^2)), and self in all-pairs mode.
//   compress  (fused_knn_{tiles,sweep}_compress_kernel, the Bf16x1 policy)
//             the mixed policy's pass 1, as the TPU kernel's bf16 MXU dot:
//             the staging prologue (stage_bf16_f32_launch) writes bf16
//             copies of the queries and the corpus and their f32 norms once
//             per call; the tile multiplies the copies on the bf16 tensor
//             cores with f32 sums. Keys clamped at 0, the zero mask off
//             (padding and self stay), k is the overfetch width 4k.
//
// What bounds it on this card. The main path (60000 queries x 60000 corpus
// rows x 784, k = 10) needs 2*60000*60000*784 ~ 5.64e12 FLOP. Exact mode
// runs them three times on the TF32 tensor cores (494.7 TFLOP/s dense on
// the H100 SXM: ~34 ms; FFMA at the 67 TFLOP/s FP32 peak would need ~84
// ms). Compress mode runs them once on mma.sync bf16 (989 TFLOP/s dense:
// ~5.7 ms); at that rate the per-key selection (an insert per survivor,
// lists of 40 restarting every 2048 columns in the tiles form) is as large
// as the product. The only bytes that must cross device memory are the
// corpus and queries (~0.4 GB, ~0.1 ms at 3.35 TB/s) and the survivors, so
// both modes are bound by operations.
//
// Selection rule. Candidates are ordered by (distance, global id): the TPU
// kernels' "ties to the leftmost column, carry first" rule, since ids rise
// with the column. A slot whose distance is not finite gets id -1. A NaN
// distance anywhere in a row's range (after the masks, as in the TPU kernel)
// turns the whole row's output into (NaN, -1), which is what the TPU's
// k-pass min extraction emits for such a row.

#include "knn_tile.cuh"

namespace {

using namespace knn;

struct Params {
  const void* q;      // (Q, D) f32 queries (exact) or (Q, Dp) bf16 copies
  const float* qn;    // (Q,) their norms, from the mode's prologue
  const void* c;      // (C, D) f32 corpus (exact) or (C, Dp) bf16 copies
  const float* cn;    // (C,)
  float* out_d;       // (n_c, Q, k)
  int* out_i;         // (n_c, Q, k)
  int Q, C, D;        // D: the width (exact) or the staged width (compress)
  int m_corpus;       // columns >= m_corpus are padding
  int k;
  int c_span;         // columns per CTA along y (C for the sweep)
  int exclude_self, exclude_zero, all_pairs;
  float zero_eps;     // > 0: absolute threshold; 0: rtol * (q^2 + c^2)
};

// Columns of a dense f32 corpus whose ids are the column numbers.
struct AffineCols {
  const float* c;
  int D;
  bool self, zero;
  float zero_eps;
  const float* cn;  // the columns' norms
  static constexpr bool clamp = true;
  static constexpr bool nan_as_inf = false;
  __device__ float load(int col, int dim) const {
    return c[(size_t)col * D + dim];
  }
  __device__ float norm(int col) const { return cn[col]; }
  __device__ bool masked(int row, int col, float d, float qs, float cs) const {
    if (zero) {
      float th = zero_eps > 0.f ? zero_eps : __fmul_rn(1e-6f, __fadd_rn(qs, cs));
      if (d <= th) return true;
    }
    return self && col == row;
  }
  __device__ int key(int col) const { return col; }
};

// emit: non-finite slots get id -1; a row that saw NaN is all (NaN, -1)
template <int ROWS, class LT>
__device__ void emit(const Params& p, const LT& L, int q0, size_t out_row0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    if (q0 + r >= p.Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    float* od = p.out_d + (out_row0 + r) * (size_t)p.k;
    int* oi = p.out_i + (out_row0 + r) * (size_t)p.k;
    bool poisoned = L.sm.nanf[r] != 0;
    for (int j = lane; j < p.k; j += 32) {
      float d = Ld[j];
      int id = Li[j];
      if (poisoned) { d = nan_f(); id = -1; }
      else if (!isfinite(d)) id = -1;
      od[j] = d;
      oi[j] = id;
    }
  }
}

// One CTA: query rows [q0, q0+MQB) against corpus columns [c_begin,
// c_end). Padding columns (>= m_corpus) are never computed: a CTA whose
// range is all padding writes only (INF, -1).
template <bool COMPRESS>
__device__ void knn_rows(const Params& p, int q0, int c_begin, int c_end,
                         size_t out_row0, unsigned char* smem) {
  c_end = min(c_end, p.m_corpus);
  const float* c = static_cast<const float*>(p.c);
  AffineCols src{c, p.D, p.exclude_self && p.all_pairs,
                 !COMPRESS && p.exclude_zero, p.zero_eps, p.cn};
  MmaLists<> L{carve_mma(smem, p.k), p.out_d, p.out_i, out_row0, p.k};
  init_lists<MQB>(L, q0, p.Q, -1);
  if constexpr (COMPRESS) {
    const bf16* qb = static_cast<const bf16*>(p.q);
    const bf16* cb = static_cast<const bf16*>(p.c);
    sweep_mma<Bf16x1, MQB>(src, Bf16Operand{qb, p.D}, p.qn, p.Q, Bf16Operand{cb, p.D},
                           p.D / MKD, q0, c_begin, c_end, L);
  } else {
    const float* q = static_cast<const float*>(p.q);
    sweep_mma<Tf32x3, MQB>(src, F32Operand<F32Rows>{F32Rows{q, p.D}, async_rows(q, p.D), p.D},
                           p.qn, p.Q, F32Operand<AffineCols>{src, async_rows(c, p.D), p.D},
                           (p.D + TKD - 1) / TKD, q0, c_begin, c_end, L);
  }
  emit<MQB>(p, L, q0, out_row0);
}

template <bool COMPRESS>
__device__ void tiles_body(const Params& p, unsigned char* smem) {
  int q0 = blockIdx.x * MQB;
  int c_begin = blockIdx.y * p.c_span;
  int c_end = min(c_begin + p.c_span, p.C);
  knn_rows<COMPRESS>(p, q0, c_begin, c_end, (size_t)blockIdx.y * p.Q + q0,
                     smem);
}

template <bool COMPRESS>
__device__ void sweep_body(const Params& p, unsigned char* smem) {
  int q0 = blockIdx.x * MQB;
  knn_rows<COMPRESS>(p, q0, 0, p.C, (size_t)q0, smem);
}

// Every kernel is capped at 128 registers a thread, so two CTAs of 256
// threads fit on an SM (their shared memory allows two for k <= 40).
__global__ void __launch_bounds__(THREADS, 2) fused_knn_tiles_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  tiles_body<false>(p, smem);
}

__global__ void __launch_bounds__(THREADS, 2) fused_knn_sweep_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sweep_body<false>(p, smem);
}

__global__ void __launch_bounds__(THREADS, 2)
fused_knn_tiles_compress_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  tiles_body<true>(p, smem);
}

__global__ void __launch_bounds__(THREADS, 2)
fused_knn_sweep_compress_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sweep_body<true>(p, smem);
}

// The exact tile's raw products q . c (a test hook, see tile_dots).
__global__ void __launch_bounds__(THREADS, 2)
exact_tile_dots_kernel(const float* q, const float* c, float* out, int Q, int C, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_dots<MQB>(F32Operand<F32Rows>{F32Rows{q, D}, async_rows(q, D), D},
                 F32Operand<F32Rows>{F32Rows{c, D}, async_rows(c, D), D},
                 (D + TKD - 1) / TKD, Q, C, blockIdx.x * MQB, blockIdx.y * MCB, smem,
                 out);
}

// The card's mma.sync rate, the ceiling of both tiles' products: every warp
// runs `iters` rounds of 16 independent products (m16n8k8 tf32 or
// m16n8k16 bf16) on register operands; the launch fills each SM with two
// CTAs of 8 warps, as the tiles do. A measurement probe, not on any path.
template <bool TF32>
__global__ void __launch_bounds__(THREADS, 2) mma_rate_kernel(float* out, int iters) {
  float acc[16][4] = {};
  const unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const unsigned b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (TF32) mma_tf32(acc[j], a, b);
      else mma_bf16(acc[j], a, b[0], b[1]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool COMPRESS>
cudaError_t launch(void (*kernel)(Params), const Params& p, int grid_y,
                   cudaStream_t stream) {
  if (p.Q <= 0 || p.C <= 0 || p.D <= 0 || p.k <= 0) return cudaErrorInvalidValue;
  if (COMPRESS && p.D % MKD) return cudaErrorInvalidValue;
  cudaError_t err = set_mma_smem((const void*)kernel, p.k);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Q + MQB - 1) / MQB, grid_y);
  kernel<<<grid, THREADS, mma_smem_bytes(p.k), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The exact forms, on f32 rows and the prologue's norms qn (Q,), cn (C,).
// out_d / out_i: (C / c_tile, Q, k); C must be a multiple of c_tile.
int fused_knn_tiles_launch(const float* q, const float* qn, const float* c,
                           const float* cn, float* out_d, int* out_i, int Q,
                           int C, int D, int m_corpus, int k, int c_tile,
                           int exclude_self, int exclude_zero, int all_pairs,
                           float zero_eps, cudaStream_t stream) {
  if (c_tile <= 0 || C % c_tile) return (int)cudaErrorInvalidValue;
  Params p{q, qn, c, cn, out_d, out_i, Q, C, D, m_corpus, k, c_tile,
           exclude_self, exclude_zero, all_pairs, zero_eps};
  return (int)launch<false>(fused_knn_tiles_kernel, p, C / c_tile, stream);
}

// out_d / out_i: (Q, k)
int fused_knn_sweep_launch(const float* q, const float* qn, const float* c,
                           const float* cn, float* out_d, int* out_i, int Q,
                           int C, int D, int m_corpus, int k, int exclude_self,
                           int exclude_zero, int all_pairs, float zero_eps,
                           cudaStream_t stream) {
  Params p{q, qn, c, cn, out_d, out_i, Q, C, D, m_corpus, k, C, exclude_self,
           exclude_zero, all_pairs, zero_eps};
  return (int)launch<false>(fused_knn_sweep_kernel, p, 1, stream);
}

// The compress forms, on the prologue's copies: qb (Q, Dp), cb (C, Dp) bf16
// and their norms qn (Q,), cn (C,); Dp a multiple of 32.
int fused_knn_tiles_compress_launch(const bf16* qb, const float* qn,
                                    const bf16* cb, const float* cn,
                                    float* out_d, int* out_i, int Q, int C,
                                    int Dp, int m_corpus, int k, int c_tile,
                                    int exclude_self, int all_pairs,
                                    cudaStream_t stream) {
  if (c_tile <= 0 || C % c_tile) return (int)cudaErrorInvalidValue;
  Params p{qb, qn, cb, cn, out_d, out_i, Q, C, Dp, m_corpus, k, c_tile,
           exclude_self, 0, all_pairs, 0.f};
  return (int)launch<true>(fused_knn_tiles_compress_kernel, p, C / c_tile, stream);
}

int fused_knn_sweep_compress_launch(const bf16* qb, const float* qn,
                                    const bf16* cb, const float* cn,
                                    float* out_d, int* out_i, int Q, int C,
                                    int Dp, int m_corpus, int k,
                                    int exclude_self, int all_pairs,
                                    cudaStream_t stream) {
  Params p{qb, qn, cb, cn, out_d, out_i, Q, C, Dp, m_corpus, k, C,
           exclude_self, 0, all_pairs, 0.f};
  return (int)launch<true>(fused_knn_sweep_compress_kernel, p, 1, stream);
}

// The compress prologue: x (N, D) f32 -> out (N, Dp) bf16, norms (N,) f32.
int stage_bf16_f32_launch(const float* x, bf16* out, float* norms, int N,
                          int D, int Dp, cudaStream_t stream) {
  return (int)stage_bf16(F32Rows{x, D}, N, D, Dp, out, norms, stream);
}

// The exact prologue: x (N, D) f32 -> norms (N,) f32 by the tile's product.
int stage_tf32_f32_launch(const float* x, float* norms, int N, int D,
                          cudaStream_t stream) {
  return (int)stage_tf32(F32Rows{x, D}, N, D, norms, stream);
}

// The exact tile's raw products: out (Q, C) = q . c^T (a test hook).
int exact_tile_dots_launch(const float* q, const float* c, float* out, int Q,
                           int C, int D, cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_mma_smem((const void*)exact_tile_dots_kernel, 0);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + MQB - 1) / MQB, (C + MCB - 1) / MCB);
  exact_tile_dots_kernel<<<grid, THREADS, mma_smem_bytes(0), stream>>>(q, c, out, Q, C, D);
  return (int)cudaGetLastError();
}

// The mma.sync rate probe: out holds 2 * SMs * THREADS floats; returns the
// FLOP it does (or a negative cudaError).
double mma_rate_launch(int tf32, int iters, float* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess || iters <= 0) return -(double)(e ? e : cudaErrorInvalidValue);
  if (tf32) mma_rate_kernel<true><<<2 * sms, THREADS, 0, stream>>>(out, iters);
  else mma_rate_kernel<false><<<2 * sms, THREADS, 0, stream>>>(out, iters);
  if ((e = cudaGetLastError()) != cudaSuccess) return -(double)e;
  // per warp and round: 16 products of 16 x 8 x (8 or 16) multiply-adds
  return 2.0 * 2 * sms * (THREADS / 32) * (double)iters * 16 * 16 * 8 * (tf32 ? 8 : 16);
}

// Registers, local (spilled) bytes a thread and CTAs per SM of kernel
// `which` (0 tiles, 1 sweep; + 2 for the compress forms) at list width k.
int kernel_info(int which, int k, int* regs, int* local_bytes, int* ctas_per_sm) {
  const void* kernels[] = {(const void*)fused_knn_tiles_kernel,
                           (const void*)fused_knn_sweep_kernel,
                           (const void*)fused_knn_tiles_compress_kernel,
                           (const void*)fused_knn_sweep_compress_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return (int)mma_kernel_info(kernels[which], k, regs, local_bytes, ctas_per_sm);
}

}  // extern "C"

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
// Modes (the `compress` flag of the TPU kernels):
//   exact     (fused_knn_{tiles,sweep}_kernel, knn_tile.cuh's
//             `sweep`) every product in full f32 with FFMA: no TF32, no
//             tensor cores, because the zero-distance exclusion threshold
//             rtol 1e-6 * (q^2 + c^2) is calibrated to f32-accurate
//             products. Masks: padding columns (>= m_corpus), zero distance
//             (d <= zero_eps if > 0, else d <= 1e-6 (q^2 + c^2)), and self
//             in all-pairs mode.
//   compress  (fused_knn_{tiles,sweep}_compress_kernel, knn_tile.cuh's
//             `sweep_bf16`) the mixed policy's pass 1, as the TPU kernel's
//             bf16 MXU dot: the staging prologue (stage_bf16_f32_launch)
//             writes bf16 copies of the queries and the corpus and their
//             f32 norms once per call; the tile multiplies the copies on
//             the bf16 tensor cores with f32 sums. Keys clamped at 0, the
//             zero mask off (padding and self stay), k is the overfetch
//             width 4k.
//
// What bounds it on this card. The main path (60000 queries x 60000 corpus
// rows x 784, k = 10) needs 2*60000*60000*784 ~ 5.64e12 FLOP. Exact mode
// runs them on FFMA against the H100 SXM's 67 TFLOP/s FP32 peak: ~84 ms.
// Compress mode runs them on mma.sync bf16 (989 TFLOP/s dense: ~5.7 ms);
// at that rate the per-key selection (one warp_offer per 32 keys, an insert
// per survivor, lists of 40 restarting every 2048 columns in the tiles
// form) is as large as the product, so compress CTAs are 128 x 128 (twice
// the exact tile's rows and columns per staged byte) and the prologue's
// bf16 copies halve what every CTA stages. The only bytes that must cross
// device memory are the corpus and queries (~0.4 GB, ~0.1 ms at 3.35 TB/s)
// and the survivors, so both modes are bound by operations.
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
  const float* q;     // (Q, D) queries (exact)
  const float* c;     // (C, D) corpus (exact)
  const bf16* qb;     // (Q, D) bf16 copies and their norms (compress; D is
  const float* qn;    //   the staged width there)
  const bf16* cb;
  const float* cn;
  float* out_d;       // (n_c, Q, k)
  int* out_i;         // (n_c, Q, k)
  int Q, C, D;
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
  static constexpr bool clamp = true;
  static constexpr bool nan_as_inf = false;
  __device__ float load(int col, int dim) const {
    return c[(size_t)col * D + dim];
  }
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

// One CTA: query rows [q0, q0+QB (MQB)) against corpus columns [c_begin,
// c_end). Padding columns (>= m_corpus) are never computed: a CTA whose
// range is all padding writes only (INF, -1).
template <bool COMPRESS>
__device__ void knn_rows(const Params& p, int q0, int c_begin, int c_end,
                         size_t out_row0, unsigned char* smem) {
  c_end = min(c_end, p.m_corpus);
  AffineCols src{p.c, p.D, p.exclude_self && p.all_pairs,
                 !COMPRESS && p.exclude_zero, p.zero_eps};
  if constexpr (COMPRESS) {
    MmaLists L{carve_mma(smem, p.k), p.out_d, p.out_i, out_row0, p.k};
    init_lists<MQB>(L, q0, p.Q, -1);
    sweep_bf16(src, p.qb, p.qn, p.Q, p.cb, p.cn, p.D, q0, c_begin, c_end, L);
    emit<MQB>(p, L, q0, out_row0);
  } else {
    Lists L{carve(smem, p.k), p.out_d, p.out_i, out_row0, p.k};
    init_lists(L, q0, p.Q, -1);
    sweep(src, p.q, p.Q, p.D, q0, c_begin, c_end, L);
    emit<QB>(p, L, q0, out_row0);
  }
}

// query rows per CTA
template <bool COMPRESS>
constexpr int kRows = COMPRESS ? MQB : QB;

template <bool COMPRESS>
__device__ void tiles_body(const Params& p, unsigned char* smem) {
  int q0 = blockIdx.x * kRows<COMPRESS>;
  int c_begin = blockIdx.y * p.c_span;
  int c_end = min(c_begin + p.c_span, p.C);
  knn_rows<COMPRESS>(p, q0, c_begin, c_end, (size_t)blockIdx.y * p.Q + q0,
                     smem);
}

template <bool COMPRESS>
__device__ void sweep_body(const Params& p, unsigned char* smem) {
  int q0 = blockIdx.x * kRows<COMPRESS>;
  knn_rows<COMPRESS>(p, q0, 0, p.C, (size_t)q0, smem);
}

__global__ void __launch_bounds__(THREADS) fused_knn_tiles_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  tiles_body<false>(p, smem);
}

__global__ void __launch_bounds__(THREADS) fused_knn_sweep_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sweep_body<false>(p, smem);
}

// The compress kernels are capped at 128 registers a thread, so two CTAs of
// 256 threads fit on an SM (their shared memory allows two for k <= 40).
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

template <bool COMPRESS>
cudaError_t launch(void (*kernel)(Params), const Params& p, int grid_y,
                   cudaStream_t stream) {
  if (p.Q <= 0 || p.C <= 0 || p.D <= 0 || p.k <= 0) return cudaErrorInvalidValue;
  if (COMPRESS && p.D % MKD) return cudaErrorInvalidValue;
  size_t smem = COMPRESS ? mma_smem_bytes(p.k) : smem_bytes(p.k);
  cudaError_t err = COMPRESS ? set_mma_smem((const void*)kernel, p.k)
                             : set_smem((const void*)kernel, p.k);
  if (err != cudaSuccess) return err;
  const int rows = kRows<COMPRESS>;
  dim3 grid((p.Q + rows - 1) / rows, grid_y);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out_d / out_i: (C / c_tile, Q, k); C must be a multiple of c_tile.
int fused_knn_tiles_launch(const float* q, const float* c, float* out_d,
                           int* out_i, int Q, int C, int D, int m_corpus,
                           int k, int c_tile, int exclude_self,
                           int exclude_zero, int all_pairs, float zero_eps,
                           cudaStream_t stream) {
  if (c_tile <= 0 || C % c_tile) return (int)cudaErrorInvalidValue;
  Params p{q, c, nullptr, nullptr, nullptr, nullptr, out_d, out_i, Q, C, D,
           m_corpus, k, c_tile, exclude_self, exclude_zero, all_pairs,
           zero_eps};
  return (int)launch<false>(fused_knn_tiles_kernel, p, C / c_tile, stream);
}

// out_d / out_i: (Q, k)
int fused_knn_sweep_launch(const float* q, const float* c, float* out_d,
                           int* out_i, int Q, int C, int D, int m_corpus,
                           int k, int exclude_self, int exclude_zero,
                           int all_pairs, float zero_eps, cudaStream_t stream) {
  Params p{q, c, nullptr, nullptr, nullptr, nullptr, out_d, out_i, Q, C, D,
           m_corpus, k, C, exclude_self, exclude_zero, all_pairs, zero_eps};
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
  Params p{nullptr, nullptr, qb, qn, cb, cn, out_d, out_i, Q, C, Dp,
           m_corpus, k, c_tile, exclude_self, 0, all_pairs, 0.f};
  return (int)launch<true>(fused_knn_tiles_compress_kernel, p, C / c_tile, stream);
}

int fused_knn_sweep_compress_launch(const bf16* qb, const float* qn,
                                    const bf16* cb, const float* cn,
                                    float* out_d, int* out_i, int Q, int C,
                                    int Dp, int m_corpus, int k,
                                    int exclude_self, int all_pairs,
                                    cudaStream_t stream) {
  Params p{nullptr, nullptr, qb, qn, cb, cn, out_d, out_i, Q, C, Dp,
           m_corpus, k, C, exclude_self, 0, all_pairs, 0.f};
  return (int)launch<true>(fused_knn_sweep_compress_kernel, p, 1, stream);
}

// The staging prologue: x (N, D) f32 -> out (N, Dp) bf16, norms (N,) f32.
int stage_bf16_f32_launch(const float* x, bf16* out, float* norms, int N,
                          int D, int Dp, cudaStream_t stream) {
  return (int)stage_bf16(F32Rows{x, D}, N, D, Dp, out, norms, stream);
}

// Registers, local (spilled) bytes a thread and CTAs per SM of the compress
// kernel `which` (0 tiles, 1 sweep) at list width k.
int compress_kernel_info(int which, int k, int* regs, int* local_bytes,
                         int* ctas_per_sm) {
  const void* kernel = which == 0 ? (const void*)fused_knn_tiles_compress_kernel
                                  : (const void*)fused_knn_sweep_compress_kernel;
  return (int)mma_kernel_info(kernel, k, regs, local_bytes, ctas_per_sm);
}

}  // extern "C"

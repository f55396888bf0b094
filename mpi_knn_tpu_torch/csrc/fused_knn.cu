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
// Both run the tile routine of knn_tile.cuh and differ only in the corpus
// column range a CTA owns and where its output lands.
//
// Modes (the `compress` flag of the TPU kernels):
//   exact     every product in full f32 with FFMA: no TF32, no tensor
//             cores, because the zero-distance exclusion threshold
//             rtol 1e-6 * (q^2 + c^2) is calibrated to f32-accurate
//             products. Masks: padding columns (>= m_corpus), zero distance
//             (d <= zero_eps if > 0, else d <= 1e-6 (q^2 + c^2)), and self
//             in all-pairs mode.
//   compress  the mixed policy's pass 1: bf16-rounded dot operands, f32
//             accumulation, norms from the unrounded rows, keys clamped at
//             0, the zero mask off (padding and self stay), k is the
//             overfetch width 4k.
//
// What bounds it on this card. The main path (60000 queries x 60000 corpus
// rows x 784, k = 10) needs 2*60000*60000*784 ~ 5.64e12 FLOP. Exact mode
// runs them on FFMA against the H100 SXM's 67 TFLOP/s FP32 peak: ~84 ms.
// Compress mode could run them on bf16 tensor cores (989 TFLOP/s dense:
// ~5.7 ms) but this simple form still uses FFMA over the rounded values, so
// it costs what exact mode costs. The only bytes that must cross device
// memory are the corpus and queries (~0.4 GB, ~0.1 ms at 3.35 TB/s) and the
// survivors, so both modes are bound by operations. Faster forms (wgmma in
// bf16 for compress, 3xTF32 for exact, TMA staging, a persistent schedule)
// are later work.
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
  const float* q;     // (Q, D) queries
  const float* c;     // (C, D) corpus
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
template <bool COMPRESS>
struct AffineCols {
  const float* c;
  int D;
  bool self, zero;
  float zero_eps;
  static constexpr bool compress = COMPRESS;
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

// One CTA: query rows [q0, q0+QB) against corpus columns [c_begin, c_end).
// Padding columns (>= m_corpus) are never computed: a CTA whose range is all
// padding writes only (INF, -1).
template <bool COMPRESS>
__device__ void knn_rows(const Params& p, int q0, int c_begin, int c_end,
                         size_t out_row0, unsigned char* smem) {
  c_end = min(c_end, p.m_corpus);
  Lists L{carve(smem, p.k), p.out_d, p.out_i, out_row0, p.k};
  init_lists(L, q0, p.Q, -1);
  AffineCols<COMPRESS> src{p.c, p.D, p.exclude_self && p.all_pairs,
                           !COMPRESS && p.exclude_zero, p.zero_eps};
  sweep(src, p.q, p.Q, p.D, q0, c_begin, c_end, L);

  // emit: non-finite slots get id -1; a row that saw NaN is all (NaN, -1)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
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

template <bool COMPRESS>
__global__ void __launch_bounds__(THREADS)
fused_knn_tiles_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int q0 = blockIdx.x * QB;
  int c_begin = blockIdx.y * p.c_span;
  int c_end = min(c_begin + p.c_span, p.C);
  knn_rows<COMPRESS>(p, q0, c_begin, c_end, (size_t)blockIdx.y * p.Q + q0,
                     smem);
}

template <bool COMPRESS>
__global__ void __launch_bounds__(THREADS)
fused_knn_sweep_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int q0 = blockIdx.x * QB;
  knn_rows<COMPRESS>(p, q0, 0, p.C, (size_t)q0, smem);
}

cudaError_t launch(void (*kernel)(Params), const Params& p, int grid_y,
                   cudaStream_t stream) {
  if (p.Q <= 0 || p.C <= 0 || p.D <= 0 || p.k <= 0) return cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)kernel, p.k);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Q + QB - 1) / QB, grid_y);
  kernel<<<grid, THREADS, smem_bytes(p.k), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out_d / out_i: (C / c_tile, Q, k); C must be a multiple of c_tile.
int fused_knn_tiles_launch(const float* q, const float* c, float* out_d,
                           int* out_i, int Q, int C, int D, int m_corpus,
                           int k, int c_tile, int exclude_self,
                           int exclude_zero, int all_pairs, int compress,
                           float zero_eps, cudaStream_t stream) {
  if (c_tile <= 0 || C % c_tile) return (int)cudaErrorInvalidValue;
  Params p{q, c, out_d, out_i, Q, C, D, m_corpus, k, c_tile,
           exclude_self, exclude_zero, all_pairs, zero_eps};
  return (int)launch(compress ? fused_knn_tiles_kernel<true>
                              : fused_knn_tiles_kernel<false>,
                     p, C / c_tile, stream);
}

// out_d / out_i: (Q, k)
int fused_knn_sweep_launch(const float* q, const float* c, float* out_d,
                           int* out_i, int Q, int C, int D, int m_corpus,
                           int k, int exclude_self, int exclude_zero,
                           int all_pairs, int compress, float zero_eps,
                           cudaStream_t stream) {
  Params p{q, c, out_d, out_i, Q, C, D, m_corpus, k, C,
           exclude_self, exclude_zero, all_pairs, zero_eps};
  return (int)launch(compress ? fused_knn_sweep_kernel<true>
                              : fused_knn_sweep_kernel<false>,
                     p, 1, stream);
}

}  // extern "C"

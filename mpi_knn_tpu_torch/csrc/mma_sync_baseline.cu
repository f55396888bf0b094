// A measurement baseline, on no path of the package: K1 and K2 at
// matmul_precision "default" / "high" as they ran before the bf16 wgmma
// tile took them (fused_knn.cu's fused_knn_bf16x1_kernel /
// fused_knn_bf16x3_kernel). knn_tile.cuh's mma.sync tile `sweep_mma` with
// the Bf16x1F32 / Bf16x3 policies loads the f32 rows by cp.async and rounds
// or splits them to bf16 in registers on every tile load, one CTA per (128
// or 64 query rows, corpus tile), with the exact form's masks and the
// norms of fused_knn.cu's stage_norms_launch. chip_smoke.py builds it
// beside the kernel sources and times it against its successor on the same
// inputs in one run; nothing routes to it.

#include "knn_tile.cuh"

namespace {

using namespace knn;

// Columns of a dense corpus whose ids are the column numbers: their norms
// and masks (padding is cut off by the caller's column range). Zero
// distance: d <= zero_eps if > 0, else d <= 1e-6 (q^2 + c^2).
struct AffineCols {
  bool self, zero;
  float zero_eps;
  const float* cn;  // the columns' norms
  static constexpr bool clamp = true;
  static constexpr bool nan_as_inf = false;
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

// emit: non-finite slots get id -1; a row that saw NaN is all (NaN, -1).
template <int ROWS, class LT>
__device__ void emit(const LT& L, const int* nanf, float* out_d, int* out_i, int Q,
                     int k, int q0, size_t out_row0, int warp, int nwarps) {
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += nwarps) {
    if (q0 + r >= Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    float* od = out_d + (out_row0 + r) * (size_t)k;
    int* oi = out_i + (out_row0 + r) * (size_t)k;
    bool poisoned = nanf[r] != 0;
    for (int j = lane; j < k; j += 32) {
      float d = Ld[j];
      int id = Li[j];
      if (poisoned) { d = nan_f(); id = -1; }
      else if (!isfinite(d)) id = -1;
      od[j] = d;
      oi[j] = id;
    }
  }
}

// The f32 rows q (Q, D) and c (C, D), the prologue's norms, outputs
// (C / c_span, Q, k) (tiles) or (Q, k) (sweep: c_span >= C).
struct MmaParams {
  const float* q;
  const float* qn;
  const float* c;
  const float* cn;
  float* out_d;
  int* out_i;
  int Q, C, D, m_corpus, k, c_span;
  int exclude_self, exclude_zero, all_pairs;
  float zero_eps;
};

// One CTA: query rows [q0, q0+ROWS) against the columns of its corpus tile
// below m_corpus. Capped at 128 registers a thread: two CTAs per SM.
template <class Op, int ROWS>
__global__ void __launch_bounds__(THREADS, 2) fused_knn_mma_kernel(MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * ROWS;
  const int c_begin = blockIdx.y * p.c_span;
  const int c_end = min(min(c_begin + p.c_span, p.C), p.m_corpus);
  const size_t out_row0 = (size_t)blockIdx.y * p.Q + q0;
  const AffineCols src{p.exclude_self && p.all_pairs, p.exclude_zero != 0, p.zero_eps, p.cn};
  MmaLists<ROWS> L{carve_mma<ROWS>(smem, p.k), p.out_d, p.out_i, out_row0, p.k};
  init_lists<ROWS>(L, q0, p.Q, -1);
  sweep_mma<Op, ROWS>(src, F32Operand<F32Rows>{F32Rows{p.q, p.D}, async_rows(p.q, p.D), p.D},
                      p.qn, p.Q,
                      F32Operand<F32Rows>{F32Rows{p.c, p.D}, async_rows(p.c, p.D), p.D},
                      (p.D + TKD - 1) / TKD, q0, c_begin, c_end, L);
  emit<ROWS>(L, L.sm.nanf, p.out_d, p.out_i, p.Q, p.k, q0, out_row0, threadIdx.x / 32,
             THREADS / 32);
}

// The CTA rows of a launch (pick_rows: 64 where 128-row CTAs would leave
// the card's resident slots empty), its kernel and dynamic shared bytes.
template <class Op>
cudaError_t mma_plan(const MmaParams& p, int grid_y, int* rows, const void** kernel,
                     size_t* smem) {
  cudaError_t e = pick_rows((const void*)fused_knn_mma_kernel<Op, MQB>, p.k,
                            (long long)((p.Q + MQB - 1) / MQB) * grid_y, rows);
  if (e != cudaSuccess) return e;
  if (*rows == MQB) {
    *kernel = (const void*)fused_knn_mma_kernel<Op, MQB>;
    *smem = mma_smem_bytes<MQB>(p.k);
    return set_mma_smem<MQB>(*kernel, p.k);
  }
  *kernel = (const void*)fused_knn_mma_kernel<Op, NQB>;
  *smem = mma_smem_bytes<NQB>(p.k);
  return set_mma_smem<NQB>(*kernel, p.k);
}

cudaError_t mma_plan_of(int precision, const MmaParams& p, int grid_y, int* rows,
                        const void** kernel, size_t* smem) {
  if (precision == 1) return mma_plan<Bf16x1F32>(p, grid_y, rows, kernel, smem);
  if (precision == 2) return mma_plan<Bf16x3>(p, grid_y, rows, kernel, smem);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1 (sweep 0) and K2 (sweep 1) at precision 1 ("default") or 2 ("high"),
// on the f32 rows q (Q, D), c (C, D) and their stage_norms_launch norms.
// out_d / out_i: (C / c_tile, Q, k), C a multiple of c_tile (tiles), or
// (Q, k) (sweep).
int fused_knn_mma_launch(const float* q, const float* qn, const float* c, const float* cn,
                         float* out_d, int* out_i, int Q, int C, int D, int m_corpus, int k,
                         int c_tile, int exclude_self, int exclude_zero, int all_pairs,
                         float zero_eps, int precision, int sweep, cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || D <= 0 || k <= 0 || (!sweep && (c_tile <= 0 || C % c_tile)))
    return (int)cudaErrorInvalidValue;
  const MmaParams p{q, qn, c, cn, out_d, out_i, Q, C, D, m_corpus, k, sweep ? C : c_tile,
                    exclude_self, exclude_zero, all_pairs, zero_eps};
  const int grid_y = sweep ? 1 : C / c_tile;
  int rows = MQB;
  const void* kernel = nullptr;
  size_t smem = 0;
  cudaError_t e = mma_plan_of(precision, p, grid_y, &rows, &kernel, &smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {const_cast<MmaParams*>(&p)};
  e = cudaLaunchKernel(kernel, dim3((Q + rows - 1) / rows, grid_y), dim3(THREADS), args, smem,
                       stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan of that launch: query rows per CTA, CTAs, and the kernel's
// registers, spilled bytes a thread and CTAs per SM.
int fused_knn_mma_plan(int Q, int C, int k, int c_tile, int precision, int sweep,
                       int* rows, int* ctas, int* regs, int* local_bytes, int* ctas_per_sm) {
  if (Q <= 0 || C <= 0 || k <= 0 || (!sweep && (c_tile <= 0 || C % c_tile)))
    return (int)cudaErrorInvalidValue;
  const MmaParams p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, Q, C, 1, C, k,
                    sweep ? C : c_tile, 0, 0, 0, 0.f};
  const int grid_y = sweep ? 1 : C / c_tile;
  const void* kernel = nullptr;
  size_t smem = 0;
  cudaError_t e = mma_plan_of(precision, p, grid_y, rows, &kernel, &smem);
  if (e != cudaSuccess) return (int)e;
  *ctas = (Q + *rows - 1) / *rows * grid_y;
  return (int)(*rows == MQB ? mma_kernel_info<MQB>(kernel, k, regs, local_bytes, ctas_per_sm)
                            : mma_kernel_info<NQB>(kernel, k, regs, local_bytes, ctas_per_sm));
}

}  // extern "C"

// What the ring kernels share (fused_ring.cu: K3a/K3b; fused_ring_dma.cu:
// K4/K5): the wire decode, norms and mask policy of a ring block's columns
// (RingCols), and K3a's exact merge of one block into the carry of one
// group of query rows, on knn_tile.cuh's Tf32x3 tile.
//
// Wires: f32 as is, bf16 widened, int8 as code * scale (one f32 multiply,
// the reference's dequantize_rows). Masks: padding by id (-1), self by id
// equality (when exclude_self), and in exact mode the zero rule
// d <= zero_eps (if > 0) else d <= 1e-6 (q^2 + c^2). A block's norms are
// those of its decoded rows, written once per call by the prologue
// (stage_tf32_wire_launch) and carried with the block as its ids are.
//
// Loads. With CG the block, its ids, its norms and the carry are read with
// ld.global.cg (__ldcg, or cp.async.cg for f32 rows), which bypasses L1:
// K5 re-reads within one launch slots that a peer card or another SM
// rewrote since, and L1 is not coherent across SMs.

#pragma once

#include "knn_tile.cuh"

namespace knn {

enum Wire { WIRE_F32 = 0, WIRE_BF16 = 1, WIRE_INT8 = 2 };

template <bool CG, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

template <int WIRE, bool COMPRESS, bool CG = false>
struct RingCols {
  const void* blk;
  const float* scale;
  const int* bids;
  const int* qids;
  int D;
  int key0;  // column col has key col - key0
  bool self, zero;
  float zero_eps;
  const float* norms;  // (B,) the decoded rows' squared norms
  static constexpr bool clamp = !COMPRESS;
  static constexpr bool nan_as_inf = COMPRESS;
  __device__ float load(int col, int dim) const {
    size_t e = (size_t)col * D + dim;
    if (WIRE == WIRE_F32) return ld<CG>(static_cast<const float*>(blk) + e);
    if (WIRE == WIRE_BF16)
      return __uint_as_float(
          (unsigned)ld<CG>(static_cast<const unsigned short*>(blk) + e) << 16);
    return __fmul_rn((float)ld<CG>(static_cast<const signed char*>(blk) + e),
                     ld<CG>(scale + col));
  }
  __device__ float norm(int col) const { return ld<CG>(norms + col); }
  __device__ bool masked(int row, int col, float d, float qs, float cs) const {
    int id = ld<CG>(bids + col);
    if (id < 0) return true;
    if (zero) {
      float th = zero_eps > 0.f ? zero_eps : __fmul_rn(1e-6f, __fadd_rn(qs, cs));
      if (d <= th) return true;
    }
    return self && id == qids[row];
  }
  __device__ int key(int col) const { return col - key0; }
};

// One ring block and the carry it merges into, for the query rows of one
// rank. The block is at its wire type; scale is its (B,) f32 per-row scales
// on the int8 wire, else null.
struct MergeArgs {
  const float* q;        // (Q, D) queries
  const float* qn;       // (Q,) their norms
  const int* qids;       // (Q,)
  const void* blk;       // (B, D) at the wire type
  const float* scale;    // (B,) int8 wire only
  const float* bn;       // (B,) the block's norms
  const int* bids;       // (B,) candidate ids, -1 = padding
  const float* carry_d;  // (Q, k)
  const int* carry_i;
  float* out_d;          // (Q, k); must not alias the carry
  int* out_i;
};

struct MergeShape {
  int Q, B, D, k;
  int exclude_self, exclude_zero;
  float zero_eps;
};

// K3a's body for query rows [q0, q0 + ROWS): ranks candidates by
// (distance, arrival), the carry's slots first in their order, then the
// block's columns in order (the reference's concat(carry | block tile) with
// ties to the leftmost column). Any NaN among a row's candidates makes the
// row (NaN, -1). The whole CTA calls it; it ends on a barrier, so a CTA may
// call it again for another group with the same shared memory.
template <int WIRE, bool CG, int ROWS>
__device__ void exact_merge_group(const MergeArgs& m, const MergeShape& s,
                                  int q0, unsigned char* smem) {
  const int k = s.k;
  MmaLists<ROWS> L{carve_mma<ROWS>(smem, k), m.out_d, m.out_i, (size_t)q0, k};
  init_lists<ROWS>(L, q0, s.Q, -1);

  // the carry arrives first: slot j has arrival j
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    if (q0 + r >= s.Q) continue;
    const float* cd = m.carry_d + (size_t)(q0 + r) * k;
    bool any_nan = false;
    for (int j0 = 0; j0 < k; j0 += 32) {
      int j = j0 + lane;
      float d = j < k ? ld<CG>(cd + j) : 0.f;
      any_nan |= warp_offer(L.d(r), L.i(r), k, d, j, j < k, lane);
    }
    if (any_nan && lane == 0) L.sm.nanf[r] = 1;
    __syncwarp();
  }
  __syncthreads();

  // then the block's columns: column col has arrival k + col
  RingCols<WIRE, false, CG> cols{m.blk, m.scale, m.bids, m.qids, s.D, -k,
                                 s.exclude_self != 0, s.exclude_zero != 0,
                                 s.zero_eps, m.bn};
  const float* blk_rows = WIRE == WIRE_F32 ? async_rows(m.blk, s.D) : nullptr;
  sweep_mma<Tf32x3, ROWS>(
      cols, F32Operand<F32Rows>{F32Rows{m.q, s.D}, async_rows(m.q, s.D), s.D}, m.qn,
      s.Q, F32Operand<RingCols<WIRE, false, CG>>{cols, blk_rows, s.D},
      (s.D + TKD - 1) / TKD, q0, 0, s.B, L);

  // emit: arrivals become ids; non-finite slots get -1; NaN rows (NaN, -1)
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    int row = q0 + r;
    if (row >= s.Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    float* od = m.out_d + (size_t)row * k;
    int* oi = m.out_i + (size_t)row * k;
    bool poisoned = L.sm.nanf[r] != 0;
    for (int j = lane; j < k; j += 32) {
      float d = Ld[j];
      int a = Li[j];
      int id = -1;
      if (poisoned) d = nan_f();
      else if (isfinite(d))
        id = a < k ? ld<CG>(m.carry_i + (size_t)row * k + a)
                   : ld<CG>(m.bids + (a - k));
      od[j] = d;
      oi[j] = id;
    }
  }
  __syncthreads();
}

}  // namespace knn

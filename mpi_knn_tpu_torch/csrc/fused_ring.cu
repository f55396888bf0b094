// The ring block merge for Hopper (sm_90a): one ring block merged into the
// per-query top-k carry, the compute of one ring round.
//
// Replaces the two bodies of mpi_knn_tpu/ops/pallas_ring.py::
// fused_block_merge:
//   block_merge_exact_kernel     <- _exact_merge_body (K3a). One CTA per 64
//       query rows sweeps the whole block (the TPU swept the block tiles on
//       a sequential grid axis with the carry in VMEM scratch) and writes
//       the merged (q_local, k) carry once.
//   block_merge_compress_kernel  <- _compress_body (K3b). One CTA per (64
//       query rows, block tile) writes that tile's top-ov column positions
//       by compressed key; the gather, exact rerank and carry merge run
//       outside the kernel, as in the reference.
//
// Both read the block at its wire type (ring_merge.cuh's RingCols) and take
// candidate ids as an operand: a ring block's ids are arbitrary after
// rotation and -1 marks padding. The exact body is ring_merge.cuh's
// exact_merge_group, which K4 and K5 (fused_ring_dma.cu) run too.
//
// Order. The exact body ranks candidates by (distance, arrival): the carry's
// slots first in their order, then the block's columns in order. That is
// the reference's concat(carry | block tile) with ties to the leftmost
// column, tile after tile; (distance, id) would pick other ids on ties,
// since block ids do not rise with the column. Any NaN among a row's
// candidates makes the row (NaN, -1), as the reference's k-pass extraction
// does. The compress body's keys are the raw q^2 - 2 q.c + c^2 (not
// clamped); per tile it emits the ov smallest by (key, column) and, when
// fewer than ov finite keys remain, the untaken columns in index order
// (the reference's taken-mask order); a NaN key counts as +inf.
//
// What bounds it. A merge of a (q_local x b) block does 2 q_local b D FLOP
// (at the P=1 MNIST shape, 60000 x 60000 x 784: 5.64e12) and reads the
// queries, block and carry once (~0.4 GB): operations bound it. The exact
// body runs them on FFMA in full f32 (67 TFLOP/s FP32 peak: ~84 ms); the
// compress body also runs FFMA over bf16-rounded values, though bf16 tensor
// cores (989 TFLOP/s: ~5.7 ms) would be its bound. Both share the simple
// register-tiled routine of knn_tile.cuh; wgmma forms are later work.

#include "ring_merge.cuh"

namespace {

using namespace knn;

struct Params {
  const float* q;        // (Q, D) queries
  const int* qids;       // (Q,)
  const void* blk;       // (B, D) at the wire type
  const float* scale;    // (B,) int8 wire only
  const int* bids;       // (B,) candidate ids, -1 = padding
  const float* carry_d;  // (Q, k) exact body only
  const int* carry_i;
  float* out_d;          // exact: (Q, k); compress: (n_c, Q, ov) list scratch
  int* out_i;            // exact: (Q, k) ids; compress: (n_c, Q, ov) positions
  int Q, B, D, k, c_tile;
  int exclude_self, exclude_zero;
  float zero_eps;
};

template <int WIRE>
__global__ void __launch_bounds__(THREADS)
block_merge_exact_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  exact_merge_group<WIRE, false>(
      MergeArgs{p.q, p.qids, p.blk, p.scale, p.bids, p.carry_d, p.carry_i,
                p.out_d, p.out_i},
      MergeShape{p.Q, p.B, p.D, p.k, p.exclude_self, p.exclude_zero,
                 p.zero_eps},
      blockIdx.x * QB, smem);
}

template <int WIRE>
__global__ void __launch_bounds__(THREADS)
block_merge_compress_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * QB;
  const int ov = p.k;
  const int t = blockIdx.y;
  const int c_begin = t * p.c_tile;
  // lists go straight to the (n_c, Q, ov) output (positions) and, for
  // ov > KMAX_SMEM, to the distance scratch of the same shape
  Lists L{carve(smem, ov), p.out_d, p.out_i, (size_t)t * p.Q + q0, ov};
  init_lists(L, q0, p.Q, 0x7fffffff);
  RingCols<WIRE, true> cols{p.blk, p.scale, p.bids, p.qids, p.D, c_begin,
                            p.exclude_self != 0, false, 0.f};
  sweep(cols, p.q, p.Q, p.D, q0, c_begin, c_begin + p.c_tile, L);

  if (ov > KMAX_SMEM) return;  // the positions are already in place
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
    if (q0 + r >= p.Q) continue;
    int* oi = p.out_i + (L.row0 + r) * (size_t)ov;
    for (int j = lane; j < ov; j += 32) oi[j] = L.i(r)[j];
  }
}

template <class K>
cudaError_t launch(K kernel, const Params& p, dim3 grid, cudaStream_t stream) {
  cudaError_t err = set_smem((const void*)kernel, p.k);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem_bytes(p.k), stream>>>(p);
  return cudaGetLastError();
}

bool bad_shape(const Params& p) {
  return p.Q <= 0 || p.B <= 0 || p.D <= 0 || p.k <= 0 || p.c_tile <= 0 ||
         p.B % p.c_tile;
}

}  // namespace

extern "C" {

// The exact merge: carry (Q, k) in, merged carry (Q, k) out. wire: 0 f32,
// 1 bf16 (uint16 bits), 2 int8 codes with a (B,) f32 scale.
int block_merge_exact_launch(const float* q, const int* qids, const void* blk,
                             const float* scale, const int* bids,
                             const float* carry_d, const int* carry_i,
                             float* out_d, int* out_i, int Q, int B, int D,
                             int k, int c_tile, int wire, int exclude_self,
                             int exclude_zero, float zero_eps,
                             cudaStream_t stream) {
  Params p{q, qids, blk, scale, bids, carry_d, carry_i, out_d, out_i,
           Q, B, D, k, c_tile, exclude_self, exclude_zero, zero_eps};
  if (bad_shape(p) || (wire == WIRE_INT8 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Q + QB - 1) / QB);
  switch (wire) {
    case WIRE_F32:
      return (int)launch(block_merge_exact_kernel<WIRE_F32>, p, grid, stream);
    case WIRE_BF16:
      return (int)launch(block_merge_exact_kernel<WIRE_BF16>, p, grid, stream);
    case WIRE_INT8:
      return (int)launch(block_merge_exact_kernel<WIRE_INT8>, p, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The compress preselect: out_pos (B / c_tile, Q, ov) tile-local column
// positions; scratch_d of the same shape is needed only for ov > 128.
int block_merge_compress_launch(const float* q, const int* qids,
                                const void* blk, const float* scale,
                                const int* bids, float* scratch_d,
                                int* out_pos, int Q, int B, int D, int ov,
                                int c_tile, int wire, int exclude_self,
                                cudaStream_t stream) {
  Params p{q, qids, blk, scale, bids, nullptr, nullptr, scratch_d, out_pos,
           Q, B, D, ov, c_tile, exclude_self, 0, 0.f};
  if (bad_shape(p) || ov > c_tile || (wire == WIRE_INT8 && scale == nullptr) ||
      (ov > KMAX_SMEM && scratch_d == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Q + QB - 1) / QB, B / c_tile);
  switch (wire) {
    case WIRE_F32:
      return (int)launch(block_merge_compress_kernel<WIRE_F32>, p, grid, stream);
    case WIRE_BF16:
      return (int)launch(block_merge_compress_kernel<WIRE_BF16>, p, grid, stream);
    case WIRE_INT8:
      return (int)launch(block_merge_compress_kernel<WIRE_INT8>, p, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

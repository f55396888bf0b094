// The ring block merge for Hopper (sm_90a): one ring block merged into the
// per-query top-k carry, the compute of one ring round.
//
// Replaces the two bodies of mpi_knn_tpu/ops/pallas_ring.py::
// fused_block_merge:
//   block_merge_exact_kernel     <- _exact_merge_body (K3a). One CTA per
//       128 (or 64) query rows sweeps the whole block (the TPU swept the
//       block tiles on a sequential grid axis with the carry in VMEM
//       scratch) and writes the merged (q_local, k) carry once.
//   block_merge_compress_kernel  <- _compress_body (K3b). One CTA per (128
//       query rows, block tile) writes that tile's top-ov column positions
//       by compressed key; the gather, exact rerank and carry merge run
//       outside the kernel, as in the reference.
//
// Both take candidate ids as an operand: a ring block's ids are arbitrary
// after rotation and -1 marks padding. The exact body is ring_merge.cuh's
// exact_merge_group, which K5 and K4's bf16 and int8 wires (fused_ring_dma.
// cu) run too (K4's f32 wire runs the same merge on knn_wgmma.cuh's tile,
// equal to this one bit for bit): knn_tile.
// cuh's Tf32x3 tile on the f32 queries and the block at its wire type (the
// f32 wire by cp.async, bf16 and int8 decoded in registers), with the norms
// the prologue (stage_tf32_wire_launch) wrote once per call: the queries'
// and, on the decoded rows, the block's, which travel with it. The compress
// body reads bf16 copies that its own prologue (stage_bf16_wire_launch)
// made once: the queries' per call, the block's per merge, the int8 wire
// dequantized (code * scale) before the rounding, so the scale reaches the
// prologue and never the tile.
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
// body runs them three times on the TF32 tensor cores (494.7 TFLOP/s:
// ~34 ms); the compress body once on the bf16 tensor cores (989 TFLOP/s:
// ~5.7 ms), where the per-tile selection of ov = 40 of every 2048 columns
// weighs as much as the product. At a ring shard (15360 queries) 128-row
// groups would fill under half of the card's resident CTA slots, so the
// exact launch takes 64-row groups there (knn_tile.cuh's pick_rows).

#include "ring_merge.cuh"

namespace {

using namespace knn;

struct Params {
  const float* q;        // (Q, D) queries
  const float* qn;       // (Q,) their norms
  const int* qids;       // (Q,)
  const void* blk;       // (B, D) at the wire type
  const float* scale;    // (B,) int8 wire only
  const float* bn;       // (B,) the decoded block's norms
  const int* bids;       // (B,) candidate ids, -1 = padding
  const float* carry_d;  // (Q, k)
  const int* carry_i;
  float* out_d;          // (Q, k)
  int* out_i;
  int Q, B, D, k, c_tile;
  int exclude_self, exclude_zero;
  float zero_eps;
};

// K3b's operands: the prologue's bf16 copies (Q, Dp) / (B, Dp), its norms.
struct CParams {
  const bf16* qb;
  const float* qn;
  const int* qids;    // (Q,)
  const bf16* bb;
  const float* bn;
  const int* bids;    // (B,) candidate ids, -1 = padding
  float* scratch_d;   // (n_c, Q, ov) list scratch, ov > KMAX_SMEM only
  int* out_pos;       // (n_c, Q, ov) positions
  int Q, B, Dp, ov, c_tile;
  int exclude_self;
};

template <int WIRE, int ROWS>
__global__ void __launch_bounds__(THREADS, 2)
block_merge_exact_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  exact_merge_group<WIRE, false, ROWS>(
      MergeArgs{p.q, p.qn, p.qids, p.blk, p.scale, p.bn, p.bids, p.carry_d,
                p.carry_i, p.out_d, p.out_i},
      MergeShape{p.Q, p.B, p.D, p.k, p.exclude_self, p.exclude_zero,
                 p.zero_eps},
      blockIdx.x * ROWS, smem);
}

// Capped at 128 registers a thread: two CTAs of 256 threads per SM.
__global__ void __launch_bounds__(THREADS, 2)
block_merge_compress_kernel(CParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * MQB;
  const int ov = p.ov;
  const int t = blockIdx.y;
  const int c_begin = t * p.c_tile;
  // lists go straight to the (n_c, Q, ov) output (positions) and, for
  // ov > KMAX_SMEM, to the distance scratch of the same shape
  MmaLists<> L{carve_mma(smem, ov), p.scratch_d, p.out_pos,
               (size_t)t * p.Q + q0, ov};
  init_lists<MQB>(L, q0, p.Q, 0x7fffffff);
  // the norms, masks and keys only: the values come from the staged copies
  RingCols<WIRE_F32, true> cols{nullptr, nullptr, p.bids, p.qids, p.Dp,
                                c_begin, p.exclude_self != 0, false, 0.f, p.bn};
  sweep_mma<Bf16x1, MQB>(cols, Bf16Operand{p.qb, p.Dp}, p.qn, p.Q,
                         Bf16Operand{p.bb, p.Dp}, p.Dp / MKD, q0, c_begin,
                         c_begin + p.c_tile, L);

  if (ov > KMAX_SMEM) return;  // the positions are already in place
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < MQB; r += THREADS / 32) {
    if (q0 + r >= p.Q) continue;
    int* oi = p.out_pos + (L.row0 + r) * (size_t)ov;
    for (int j = lane; j < ov; j += 32) oi[j] = L.i(r)[j];
  }
}

template <int WIRE>
const void* exact_kernel(int rows) {
  return rows == MQB ? (const void*)block_merge_exact_kernel<WIRE, MQB>
                     : (const void*)block_merge_exact_kernel<WIRE, NQB>;
}

const void* exact_kernel_of(int wire, int rows) {
  switch (wire) {
    case WIRE_F32: return exact_kernel<WIRE_F32>(rows);
    case WIRE_BF16: return exact_kernel<WIRE_BF16>(rows);
    case WIRE_INT8: return exact_kernel<WIRE_INT8>(rows);
  }
  return nullptr;
}

// The query rows per CTA of K3a at this shape (knn_tile.cuh's pick_rows).
cudaError_t exact_rows(int wire, int Q, int k, int* rows) {
  return pick_rows(exact_kernel_of(wire, MQB), k, (Q + MQB - 1) / MQB, rows);
}

bool bad_shape(const Params& p) {
  return p.Q <= 0 || p.B <= 0 || p.D <= 0 || p.k <= 0 || p.c_tile <= 0 ||
         p.B % p.c_tile;
}

}  // namespace

extern "C" {

// The exact merge: carry (Q, k) in, merged carry (Q, k) out; qn (Q,) and
// bn (B,) are the prologue's norms of the queries and the decoded block.
// wire: 0 f32, 1 bf16 (uint16 bits), 2 int8 codes with a (B,) f32 scale.
int block_merge_exact_launch(const float* q, const float* qn, const int* qids,
                             const void* blk, const float* scale,
                             const float* bn, const int* bids,
                             const float* carry_d, const int* carry_i,
                             float* out_d, int* out_i, int Q, int B, int D,
                             int k, int c_tile, int wire, int exclude_self,
                             int exclude_zero, float zero_eps,
                             cudaStream_t stream) {
  Params p{q, qn, qids, blk, scale, bn, bids, carry_d, carry_i, out_d, out_i,
           Q, B, D, k, c_tile, exclude_self, exclude_zero, zero_eps};
  if (bad_shape(p) || !qn || !bn || exact_kernel_of(wire, MQB) == nullptr ||
      (wire == WIRE_INT8 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  int rows = MQB;
  cudaError_t err = exact_rows(wire, Q, k, &rows);
  const void* kernel = exact_kernel_of(wire, rows);
  if (err == cudaSuccess)
    err = rows == MQB ? set_mma_smem<MQB>(kernel, k) : set_mma_smem<NQB>(kernel, k);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = rows == MQB ? mma_smem_bytes<MQB>(k) : mma_smem_bytes<NQB>(k);
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((Q + rows - 1) / rows), dim3(THREADS), args,
                         smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3a's plan at this shape: query rows per CTA, CTAs, and the chosen
// kernel's registers, spilled bytes a thread and CTAs per SM.
int block_merge_exact_plan(int wire, int Q, int k, int* rows, int* ctas,
                           int* regs, int* local_bytes, int* ctas_per_sm) {
  if (exact_kernel_of(wire, MQB) == nullptr || Q <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = exact_rows(wire, Q, k, rows);
  if (err != cudaSuccess) return (int)err;
  *ctas = (Q + *rows - 1) / *rows;
  const void* kernel = exact_kernel_of(wire, *rows);
  return (int)(*rows == MQB
                   ? mma_kernel_info<MQB>(kernel, k, regs, local_bytes, ctas_per_sm)
                   : mma_kernel_info<NQB>(kernel, k, regs, local_bytes, ctas_per_sm));
}

// The compress preselect on the prologue's copies: out_pos (B / c_tile, Q,
// ov) tile-local column positions; scratch_d of the same shape is needed
// only for ov > 128. Dp is a multiple of 32.
int block_merge_compress_launch(const bf16* qb, const float* qn,
                                const int* qids, const bf16* bb,
                                const float* bn, const int* bids,
                                float* scratch_d, int* out_pos, int Q, int B,
                                int Dp, int ov, int c_tile, int exclude_self,
                                cudaStream_t stream) {
  CParams p{qb, qn, qids, bb, bn, bids, scratch_d, out_pos, Q, B, Dp, ov,
            c_tile, exclude_self};
  if (Q <= 0 || B <= 0 || Dp <= 0 || Dp % MKD || ov <= 0 || c_tile <= 0 ||
      B % c_tile || ov > c_tile || (ov > KMAX_SMEM && scratch_d == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_mma_smem((const void*)block_merge_compress_kernel, ov);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + MQB - 1) / MQB, B / c_tile);
  block_merge_compress_kernel<<<grid, THREADS, mma_smem_bytes(ov), stream>>>(p);
  return (int)cudaGetLastError();
}

// The compress prologue on a wire: x (N, D) at the wire type (scale (N,)
// on the int8 wire) -> out (N, Dp) bf16 of the decoded rows, norms (N,) f32.
int stage_bf16_wire_launch(const void* x, const float* scale, int wire,
                           bf16* out, float* norms, int N, int D, int Dp,
                           cudaStream_t stream) {
  switch (wire) {
    case WIRE_F32:
      return (int)stage_bf16(RingCols<WIRE_F32, true>{x, nullptr, nullptr, nullptr, D},
                             N, D, Dp, out, norms, stream);
    case WIRE_BF16:
      return (int)stage_bf16(RingCols<WIRE_BF16, true>{x, nullptr, nullptr, nullptr, D},
                             N, D, Dp, out, norms, stream);
    case WIRE_INT8:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return (int)stage_bf16(RingCols<WIRE_INT8, true>{x, scale, nullptr, nullptr, D},
                             N, D, Dp, out, norms, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The exact prologue on a wire: x (N, D) at the wire type -> norms (N,) f32
// of the decoded rows, by the exact tile's product.
int stage_tf32_wire_launch(const void* x, const float* scale, int wire,
                           float* norms, int N, int D, cudaStream_t stream) {
  switch (wire) {
    case WIRE_F32:
      return (int)stage_tf32(RingCols<WIRE_F32, false>{x, nullptr, nullptr, nullptr, D},
                             N, D, norms, stream);
    case WIRE_BF16:
      return (int)stage_tf32(RingCols<WIRE_BF16, false>{x, nullptr, nullptr, nullptr, D},
                             N, D, norms, stream);
    case WIRE_INT8:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return (int)stage_tf32(RingCols<WIRE_INT8, false>{x, scale, nullptr, nullptr, D},
                             N, D, norms, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Registers, local (spilled) bytes a thread and CTAs per SM of K3b at list
// width ov.
int compress_kernel_info(int ov, int* regs, int* local_bytes, int* ctas_per_sm) {
  return (int)mma_kernel_info((const void*)block_merge_compress_kernel, ov, regs,
                              local_bytes, ctas_per_sm);
}

}  // extern "C"

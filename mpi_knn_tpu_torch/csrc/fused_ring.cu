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
// Both read the block at its wire type through a template: f32 as is, bf16
// widened, int8 as code * scale (one f32 multiply, the reference's
// dequantize_rows), and take candidate ids as an operand: a ring block's
// ids are arbitrary after rotation and -1 marks padding. Masks: padding by
// id, self by id equality (when exclude_self), and in the exact body the
// zero rule d <= zero_eps (if > 0) else d <= 1e-6 (q^2 + c^2).
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

#include "knn_tile.cuh"

namespace {

using namespace knn;

enum Wire { WIRE_F32 = 0, WIRE_BF16 = 1, WIRE_INT8 = 2 };

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

template <int WIRE, bool COMPRESS>
struct RingCols {
  const void* blk;
  const float* scale;
  const int* bids;
  const int* qids;
  int D;
  int key0;  // column col has key col - key0
  bool self, zero;
  float zero_eps;
  static constexpr bool compress = COMPRESS;
  static constexpr bool clamp = !COMPRESS;
  static constexpr bool nan_as_inf = COMPRESS;
  __device__ float load(int col, int dim) const {
    size_t e = (size_t)col * D + dim;
    if (WIRE == WIRE_F32) return static_cast<const float*>(blk)[e];
    if (WIRE == WIRE_BF16)
      return __uint_as_float((unsigned)static_cast<const uint16_t*>(blk)[e] << 16);
    return __fmul_rn((float)static_cast<const int8_t*>(blk)[e], scale[col]);
  }
  __device__ bool masked(int row, int col, float d, float qs, float cs) const {
    int id = bids[col];
    if (id < 0) return true;
    if (zero) {
      float th = zero_eps > 0.f ? zero_eps : __fmul_rn(1e-6f, __fadd_rn(qs, cs));
      if (d <= th) return true;
    }
    return self && id == qids[row];
  }
  __device__ int key(int col) const { return col - key0; }
};

template <int WIRE, bool COMPRESS>
__device__ RingCols<WIRE, COMPRESS> ring_cols(const Params& p, int key0) {
  return RingCols<WIRE, COMPRESS>{p.blk, p.scale, p.bids, p.qids, p.D, key0,
                                  p.exclude_self != 0,
                                  !COMPRESS && p.exclude_zero != 0, p.zero_eps};
}

template <int WIRE>
__global__ void __launch_bounds__(THREADS)
block_merge_exact_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * QB;
  const int k = p.k;
  Lists L{carve(smem, k), p.out_d, p.out_i, (size_t)q0, k};
  init_lists(L, q0, p.Q, -1);

  // the carry arrives first: slot j has arrival j
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
    if (q0 + r >= p.Q) continue;
    const float* cd = p.carry_d + (size_t)(q0 + r) * k;
    bool any_nan = false;
    for (int j0 = 0; j0 < k; j0 += 32) {
      int j = j0 + lane;
      float d = j < k ? cd[j] : 0.f;
      any_nan |= warp_offer(L.d(r), L.i(r), k, d, j, j < k, lane);
    }
    if (any_nan && lane == 0) L.sm.nanf[r] = 1;
    __syncwarp();
  }
  __syncthreads();

  // then the block's columns: column col has arrival k + col
  sweep(ring_cols<WIRE, false>(p, -k), p.q, p.Q, p.D, q0, 0, p.B, L);

  // emit: arrivals become ids; non-finite slots get -1; NaN rows (NaN, -1)
  for (int r = warp; r < QB; r += THREADS / 32) {
    int row = q0 + r;
    if (row >= p.Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    float* od = p.out_d + (size_t)row * k;
    int* oi = p.out_i + (size_t)row * k;
    bool poisoned = L.sm.nanf[r] != 0;
    for (int j = lane; j < k; j += 32) {
      float d = Ld[j];
      int a = Li[j];
      int id = -1;
      if (poisoned) d = nan_f();
      else if (isfinite(d))
        id = a < k ? p.carry_i[(size_t)row * k + a] : p.bids[a - k];
      od[j] = d;
      oi[j] = id;
    }
  }
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
  sweep(ring_cols<WIRE, true>(p, c_begin), p.q, p.Q, p.D, q0, c_begin,
        c_begin + p.c_tile, L);

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

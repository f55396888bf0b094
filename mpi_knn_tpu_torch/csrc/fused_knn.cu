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
//   exact     (fused_knn_{tiles,sweep}_kernel) on knn_wgmma.cuh's tile: the
//             prologue (stage_tf32_split_launch) splits the queries and the
//             corpus once each into TF32 hi and lo planes with their norms;
//             the tile loads the planes by TMA and multiplies them in three
//             wgmma passes (lo.hi, hi.lo, hi.hi) with f32 sums promoted
//             interval by interval. The products are f32-accurate, as the
//             zero-distance exclusion threshold rtol 1e-6 * (q^2 + c^2)
//             needs. One persistent CTA per SM walks the items: query
//             groups of 128 rows (sweep), or (query group, corpus tile)
//             pairs in bands of 8 groups (tiles). Masks: padding columns
//             (>= m_corpus), zero distance (d <= zero_eps if > 0, else
//             d <= 1e-6 (q^2 + c^2)), and self in all-pairs mode.
//   compress  the mixed policy's pass 1, as the TPU kernel's bf16 MXU dot:
//             the staging prologue (stage_bf16_f32_launch) writes bf16
//             copies of the queries and the corpus and their f32 norms once
//             per call; the tiles multiply the copies on the bf16 tensor
//             cores with f32 sums. Keys clamped at 0, the zero mask off
//             (padding and self stay), k is the overfetch width 4k.
//             fused_knn_tiles_compress_kernel runs knn_tile.cuh's mma.sync
//             tile `sweep_mma<Bf16x1>`, 128 x 128 per CTA;
//             fused_knn_sweep_compress_kernel (K2[c]) runs knn_wgmma_bf16.cuh's
//             tile: TMA, one wgmma bf16 pass, the survivors filtered in
//             registers, and (query group x corpus slice) items whose
//             slice lists the last CTA of a group merges.
//
// What bounds it on this card. The main path (60000 queries x 60000 corpus
// rows x 784, k = 10) needs 2*60000*60000*784 ~ 5.64e12 FLOP. Exact mode
// runs them three times on the TF32 tensor cores (494.7 TFLOP/s dense on
// the H100 SXM: ~34 ms; FFMA at the 67 TFLOP/s FP32 peak would need ~84
// ms). Compress mode runs them once on bf16 (989 TFLOP/s dense: ~5.7
// ms); at that rate the per-key selection (an insert per survivor, lists
// of 40 restarting every 2048 columns in the tiles form) is as large as
// the product unless the losing keys are dropped in registers. The only bytes that must cross device memory are the
// corpus and queries (~0.4 GB, ~0.1 ms at 3.35 TB/s) and the survivors, so
// both modes are bound by operations.
//
// Selection rule. Candidates are ordered by (distance, global id): the TPU
// kernels' "ties to the leftmost column, carry first" rule, since ids rise
// with the column. A slot whose distance is not finite gets id -1. A NaN
// distance anywhere in a row's range (after the masks, as in the TPU kernel)
// turns the whole row's output into (NaN, -1), which is what the TPU's
// k-pass min extraction emits for such a row.

#include "knn_wgmma_bf16.cuh"

namespace {

using namespace knn;

struct Params {
  const void* q;      // (Q, Dp) bf16 copies
  const float* qn;    // (Q,) their norms, from the prologue
  const void* c;      // (C, Dp) bf16 copies
  const float* cn;    // (C,)
  float* out_d;       // (n_c, Q, k)
  int* out_i;         // (n_c, Q, k)
  int Q, C, D;        // D: the staged width
  int m_corpus;       // columns >= m_corpus are padding
  int k;
  int c_span;         // columns per CTA along y
  int exclude_self, all_pairs;
};

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
// Warp `warp` of `nwarps` writes rows warp, warp + nwarps, ...
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

// One compress CTA: query rows [q0, q0+MQB) against corpus columns
// [c_begin, c_end). Padding columns (>= m_corpus) are never computed: a CTA
// whose range is all padding writes only (INF, -1).
__device__ void knn_rows(const Params& p, int q0, int c_begin, int c_end,
                         size_t out_row0, unsigned char* smem) {
  c_end = min(c_end, p.m_corpus);
  AffineCols src{p.exclude_self && p.all_pairs, false, 0.f, p.cn};
  MmaLists<> L{carve_mma(smem, p.k), p.out_d, p.out_i, out_row0, p.k};
  init_lists<MQB>(L, q0, p.Q, -1);
  const bf16* qb = static_cast<const bf16*>(p.q);
  const bf16* cb = static_cast<const bf16*>(p.c);
  sweep_mma<Bf16x1, MQB>(src, Bf16Operand{qb, p.D}, p.qn, p.Q, Bf16Operand{cb, p.D},
                         p.D / MKD, q0, c_begin, c_end, L);
  emit<MQB>(L, L.sm.nanf, p.out_d, p.out_i, p.Q, p.k, q0, out_row0, threadIdx.x / 32,
            THREADS / 32);
}

// K1[c] is capped at 128 registers a thread, so two CTAs of 256 threads
// fit on an SM (their shared memory allows two for k <= 40).
__global__ void __launch_bounds__(THREADS, 2)
fused_knn_tiles_compress_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int q0 = blockIdx.x * MQB;
  int c_begin = blockIdx.y * p.c_span;
  int c_end = min(c_begin + p.c_span, p.C);
  knn_rows(p, q0, c_begin, c_end, (size_t)blockIdx.y * p.Q + q0, smem);
}


// The exact form's consumer hooks over knn_wgmma.cuh's tile: the masked
// keys of each chunk into the key tile, the selection, and at the end of an
// item its lists to the output rows. Each consumer warpgroup keys, selects
// and emits its own 64 rows (warp w of the group owns rows w, w + 4, ...),
// so it syncs only with itself and one group's selection overlaps the
// other's products.
template <class Items>
struct ExactEpi {
  Items walk;
  AffineCols src;
  const float* qn;   // (Q,) the prologue's query norms
  float* out_d;      // (n_c, Q, k) or (Q, k)
  int* out_i;
  int Q, k, nkb;
  __device__ int items() const { return walk.items(); }
  __device__ wg::Item item(int n) const { return walk.item(n); }
  // the lists of warpgroup g's rows, numbered from its first row
  __device__ wg::WgLists lists(const wg::Item& t, const wg::Ctx& c) const {
    const int r0 = 64 * c.g;
    return wg::WgLists{c.Lsd + r0 * k, c.Lsi + r0 * k, out_d, out_i, t.out_row0 + r0, k};
  }
  __device__ void begin(const wg::Item& t, const wg::Ctx& c) const {
    init_rows<64>(lists(t, c), c.nanf + 64 * c.g, t.q0 + 64 * c.g, Q, -1, c.cwarp % 4, 4);
    __syncwarp();
  }
  __device__ void chunk(const float (&acc)[64], const wg::Item& t, int col0,
                        const wg::Ctx& c) const {
    wg::group_sync(c.g);  // the group's warps have read its previous keys
    const int w = c.cwarp % 4, r0 = 64 * c.g + 16 * w + c.lane / 4;
    const float qs2[2] = {t.q0 + r0 < Q ? qn[t.q0 + r0] : 0.f,
                          t.q0 + r0 + 8 < Q ? qn[t.q0 + r0 + 8] : 0.f};
    float* Ds = c.Ds + 64 * c.g * MDS;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = wg::acc_row(w, c.lane, i), cc = wg::acc_col(c.lane, i);
      const int row = t.q0 + 64 * c.g + r, col = col0 + cc;
      const float qs = qs2[(i % 4) / 2];
      const float cs = col < t.c_end ? src.norm(col) : 0.f;
      float d = __fadd_rn(__fsub_rn(qs, __fmul_rn(2.f, acc[i])), cs);
      d = d < 0.f ? 0.f : d;  // max(d, 0) that keeps NaN
      const bool invalid = col >= t.c_end || row >= Q || src.masked(row, col, d, qs, cs);
      Ds[r * MDS + cc] = invalid ? inf_f() : d;
    }
    wg::group_sync(c.g);
    select_chunk<64>(src, Ds, c.nanf + 64 * c.g, lists(t, c), t.q0 + 64 * c.g, Q, col0,
                     t.c_end, w, 4);
  }
  __device__ void end(const wg::Item& t, const wg::Ctx& c) const {
    emit<64>(lists(t, c), c.nanf + 64 * c.g, out_d, out_i, Q, k, t.q0 + 64 * c.g,
             t.out_row0 + 64 * c.g, c.cwarp % 4, 4);
  }
};

// The tile's raw products (a test hook): every (query group, column chunk)
// item writes its accumulators to out (Q, C).
struct DotsEpi {
  float* out;
  int Q, C, nkb, k;
  __device__ int groups() const { return (Q + wg::ROWS - 1) / wg::ROWS; }
  __device__ int items() const { return groups() * ((C + wg::COLS - 1) / wg::COLS); }
  __device__ wg::Item item(int n) const {
    const int qg = n % groups(), c0 = n / groups() * wg::COLS;
    return wg::Item{qg * wg::ROWS, c0, min(c0 + wg::COLS, C), 0};
  }
  __device__ void begin(const wg::Item&, const wg::Ctx&) const {}
  __device__ void end(const wg::Item&, const wg::Ctx&) const {}
  __device__ void chunk(const float (&acc)[64], const wg::Item& t, int col0,
                        const wg::Ctx& c) const {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = t.q0 + 64 * c.g + wg::acc_row(c.cwarp % 4, c.lane, i);
      const int col = col0 + wg::acc_col(c.lane, i);
      if (row < Q && col < t.c_end) out[(size_t)row * C + col] = acc[i];
    }
  }
};

#define WG_KERNEL(name, Epi)                                                          \
  __global__ void __launch_bounds__(wg::THREADS, 1)                                   \
      name(const __grid_constant__ CUtensorMap qh, const __grid_constant__ CUtensorMap ql, \
           const __grid_constant__ CUtensorMap ch, const __grid_constant__ CUtensorMap cl, \
           const Epi epi) {                                                           \
    extern __shared__ __align__(1024) unsigned char smem[];                          \
    wg::run_tile(&qh, &ql, &ch, &cl, epi, smem);                                      \
  }

// K2[c]'s consumer hooks over knn_wgmma_bf16.cuh's tile: the keys of each
// chunk filtered in registers into the warp's lists, and at the end of an
// item its lists to the output rows (S = 1) or to the item's slice of the
// scratch; the last CTA of a query group merges the group's S slices.
// Each consumer warp inits, selects, emits and merges its own 16 rows.
struct CompressSweepEpi {
  wgb::SweepWalk walk;
  const float* qn;   // (Q,) the prologue's query norms
  const float* cn;   // (C,) its corpus norms
  float* out_d;      // (Q, k)
  int* out_i;
  float* part_d;     // (S, Q, k) when S > 1
  int* part_i;
  int* counters;     // (groups,): zero on entry, left at zero
  int Q, k, nkb;
  bool self;         // mask the column equal to the row (all pairs)
  static constexpr bool has_norms = true;
  __device__ int items() const { return walk.items(); }
  __device__ wgb::Item item(int n) const { return walk.item(n); }
  // the item's lists: shared memory, or the rows of its output block
  __device__ wgb::Lists lists(const wgb::Item& t, const wgb::Ctx& c) const {
    const bool split = walk.slices > 1;
    return wgb::Lists{c.Lsd, c.Lsi, split ? part_d : out_d, split ? part_i : out_i,
                      (split ? (size_t)t.slice * Q : 0) + t.q0, k};
  }
  __device__ void begin(const wgb::Item& t, const wgb::Ctx& c) const {
    const wgb::Lists L = lists(t, c);
    for (int r = 16 * c.cwarp; r < 16 * c.cwarp + 16; ++r) {
      if (c.lane == 0) c.nanf[r] = c.bufn[r] = 0;
      if (t.q0 + r >= Q) continue;
      for (int j = c.lane; j < k; j += 32) { L.d(r)[j] = inf_f(); L.i(r)[j] = -1; }
    }
    __syncwarp();
  }
  __device__ __forceinline__ void chunk(float (&acc)[wgb::ACC], const wgb::Item& t,
                                        int col0, const float* norms, uint32_t release,
                                        const wgb::Ctx& c) const {
    const int wrow0 = 16 * c.cwarp, r0 = t.q0 + wrow0 + c.lane / 4;
    const int row[2] = {r0, r0 + 8};
    const bool live[2] = {row[0] < Q, row[1] < Q};
    const float qs[2] = {live[0] ? qn[row[0]] : 0.f, live[1] ? qn[row[1]] : 0.f};
    wgb::select_regs(acc, col0, t.c_end, row, live, qs, self, norms, release, lists(t, c),
                     wrow0, c.nanf, c.bufn, c.cd, c.ci, c.lane);
  }
  __device__ void end(const wgb::Item& t, const wgb::Ctx& c) const {
    const wgb::Lists L = lists(t, c);
    const int wrow0 = 16 * c.cwarp;
    // the winners still buffered into their lists
    const unsigned rows = __ballot_sync(
        FULL, c.lane < 16 && t.q0 + wrow0 + c.lane < Q && c.bufn[wrow0 + (c.lane & 15)] > 0);
    wgb::flush_rows(rows, L, wrow0, c.bufn, c.cd, c.ci, c.lane);
    for (int r = wrow0; r < wrow0 + 16; ++r) {  // emit: the lists to their rows
      if (t.q0 + r >= Q) continue;
      const bool poisoned = c.nanf[r] != 0;
      float* od = L.gd + (L.row0 + r) * (size_t)k;
      int* oi = L.gi + (L.row0 + r) * (size_t)k;
      for (int j = c.lane; j < k; j += 32) {
        float d = L.d(r)[j];
        int id = L.i(r)[j];
        if (poisoned) { d = nan_f(); id = -1; }
        else if (!isfinite(d)) id = -1;
        od[j] = d;
        oi[j] = id;
      }
    }
    if (walk.slices == 1) return;
    // the group's last slice to finish merges them all: each thread's
    // scratch writes are released before the count, acquired after it
    __threadfence();
    wgb::consumer_sync();
    if (c.ctid == 0) {
      const int last = atomicAdd(counters + t.group, 1) == walk.slices - 1;
      if (last) {
        counters[t.group] = 0;
        __threadfence();
      }
      *c.flag = last;
    }
    wgb::consumer_sync();
    if (*c.flag) merge_slices(t, c);
  }
  // the S slice lists of the warp's rows merged by (distance, column) into
  // the output rows; a row poisoned in any slice comes out all (NaN, -1)
  __device__ void merge_slices(const wgb::Item& t, const wgb::Ctx& c) const {
    const int S = walk.slices, lane = c.lane;
    const size_t pitch = (size_t)Q * k;
    for (int r = 16 * c.cwarp; r < 16 * c.cwarp + 16; ++r) {
      const int q = t.q0 + r;
      if (q >= Q) continue;
      const float* pd = part_d + (size_t)q * k;
      const int* pi = part_i + (size_t)q * k;
      float* od = out_d + (size_t)q * k;
      int* oi = out_i + (size_t)q * k;
      bool nan = false;
      for (int s = lane; s < S; s += 32) nan |= isnan(__ldcg(pd + s * pitch));
      if (__any_sync(FULL, nan)) {
        for (int j = lane; j < k; j += 32) { od[j] = nan_f(); oi[j] = -1; }
        continue;
      }
      // slice 0's list into the output row, then each other slice's merged in
      for (int j = lane; j < k; j += 32) { od[j] = __ldcg(pd + j); oi[j] = __ldcg(pi + j); }
      __syncwarp();
      for (int s = 1; s < S; ++s)
        for (int j0 = 0; j0 < k; j0 += 32)
          wgb::merge_cands<true>(od, oi, k, pd + s * pitch + j0, pi + s * pitch + j0,
                                 min(32, k - j0), lane);
      __syncwarp();
    }
  }
};

// The bf16 tile's raw products (a test hook and the product-alone probe):
// every item of the walk writes its accumulators to out (Q, C), or with
// `sink` only folds them into a value that is stored when it equals an
// unlikely constant, so the products are computed and nothing is written.
struct Bf16DotsEpi {
  wgb::SweepWalk walk;
  float* out;
  int Q, C, nkb, k, sink;
  static constexpr bool has_norms = false;
  __device__ int items() const { return walk.items(); }
  __device__ wgb::Item item(int n) const { return walk.item(n); }
  __device__ void begin(const wgb::Item&, const wgb::Ctx&) const {}
  __device__ void end(const wgb::Item&, const wgb::Ctx&) const {}
  __device__ void chunk(const float (&acc)[wgb::ACC], const wgb::Item& t, int col0,
                        const float*, uint32_t release, const wgb::Ctx& c) const {
    __syncwarp();
    if (c.lane == 0) wg::mbar_arrive(release);  // no norms to read
    if (sink) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < wgb::ACC; ++i) s += acc[i];
      if (s == -1.2345e-30f) out[0] = s;
      return;
    }
#pragma unroll
    for (int i = 0; i < wgb::ACC; ++i) {
      const int row = t.q0 + 16 * c.cwarp + c.lane / 4 + 8 * ((i % 4) / 2);
      const int col = col0 + 8 * (i / 4) + 2 * (c.lane % 4) + i % 2;
      if (row < Q && col < t.c_end) out[(size_t)row * C + col] = acc[i];
    }
  }
};

#define WGB_KERNEL(name, Epi)                                                         \
  __global__ void __launch_bounds__(wgb::THREADS, 1)                                  \
      name(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap cm, \
           const __grid_constant__ CUtensorMap nm, const Epi epi) {                   \
    extern __shared__ __align__(1024) unsigned char smem[];                          \
    wgb::run_tile(&qm, &cm, Epi::has_norms ? &nm : nullptr, epi, smem);               \
  }

WGB_KERNEL(fused_knn_sweep_compress_kernel, CompressSweepEpi)
WGB_KERNEL(bf16_tile_dots_kernel, Bf16DotsEpi)

// The bf16 tile's maps of the query copy (Q, Dp) and the corpus copy (C, Dp).
cudaError_t bf16_maps(CUtensorMap* qm, CUtensorMap* cm, const bf16* qb, const bf16* cb, int Q,
                      int C, int Dp) {
  cudaError_t e = wgb::bf16_map(qm, qb, Q, Dp, wgb::ROWS);
  if (e == cudaSuccess) e = wgb::bf16_map(cm, cb, C, Dp, wgb::COLS);
  return e;
}

WG_KERNEL(fused_knn_tiles_kernel, ExactEpi<wg::TileItems>)
WG_KERNEL(fused_knn_sweep_kernel, ExactEpi<wg::SweepItems>)
WG_KERNEL(split_tile_dots_kernel, DotsEpi)

// The four planes' tensor maps: queries (Q, Dp), columns (C, Dp).
struct Maps {
  CUtensorMap qh, ql, ch, cl;
};

cudaError_t make_maps(Maps* m, const float* qh, const float* ql, const float* ch,
                      const float* cl, int Q, int C, int Dp) {
  cudaError_t e = wg::plane_map(&m->qh, qh, Q, Dp);
  if (e == cudaSuccess) e = wg::plane_map(&m->ql, ql, Q, Dp);
  if (e == cudaSuccess) e = wg::plane_map(&m->ch, ch, C, Dp);
  if (e == cudaSuccess) e = wg::plane_map(&m->cl, cl, C, Dp);
  return e;
}

// Launch a tile kernel on the planes' maps: a persistent grid of
// min(items, SMs) CTAs.
#define LAUNCH_WG(kernel, maps, epi, items, k, stream)                                \
  do {                                                                                \
    int grid_ = 0, per_sm_ = 0;                                                       \
    cudaError_t e_ = wg::tile_grid((const void*)kernel, k, items, &grid_, &per_sm_);  \
    if (e_ != cudaSuccess) return (int)e_;                                            \
    kernel<<<grid_, wg::THREADS, wg::smem_bytes(k), stream>>>(maps.qh, maps.ql, maps.ch, \
                                                              maps.cl, epi);          \
    return (int)cudaGetLastError();                                                   \
  } while (0)

// The exact kernels' epilogue for the prologue's planes and norms.
template <class Items>
ExactEpi<Items> exact_epi(Items walk, const float* qn, const float* cn, float* out_d,
                          int* out_i, int Q, int Dp, int k, int exclude_self,
                          int exclude_zero, int all_pairs, float zero_eps) {
  AffineCols src{exclude_self && all_pairs, exclude_zero != 0, zero_eps, cn};
  return ExactEpi<Items>{walk, src, qn, out_d, out_i, Q, k, Dp / wg::KB};
}

// The mma.sync exact tile's (K3a's, K4's, K5's) raw products q . c (a test
// hook, see tile_dots).
__global__ void __launch_bounds__(THREADS, 2)
exact_tile_dots_kernel(const float* q, const float* c, float* out, int Q, int C, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_dots<MQB>(F32Operand<F32Rows>{F32Rows{q, D}, async_rows(q, D), D},
                 F32Operand<F32Rows>{F32Rows{c, D}, async_rows(c, D), D},
                 (D + TKD - 1) / TKD, Q, C, blockIdx.x * MQB, blockIdx.y * MCB, smem,
                 out);
}

// The card's mma.sync rate, the ceiling of knn_tile.cuh's products: every warp
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

cudaError_t launch_compress(void (*kernel)(Params), const Params& p, int grid_y,
                            cudaStream_t stream) {
  if (p.Q <= 0 || p.C <= 0 || p.D <= 0 || p.k <= 0 || p.D % MKD) return cudaErrorInvalidValue;
  cudaError_t err = set_mma_smem((const void*)kernel, p.k);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Q + MQB - 1) / MQB, grid_y);
  kernel<<<grid, THREADS, mma_smem_bytes(p.k), stream>>>(p);
  return cudaGetLastError();
}

// The card's wgmma rate, the ceiling of the exact tile's products: two
// warpgroups per CTA, one CTA per SM (the tile's shape), each issuing
// `iters` rounds of 16 m64n128k8 TF32 products on a zeroed shared box. A
// measurement probe, not on any path.
__global__ void __launch_bounds__(wg::STAGE_THREADS, 1) wgmma_rate_kernel(float* out, int iters) {
  __shared__ __align__(1024) unsigned char box[wg::TILE_BYTES];
  for (int i = threadIdx.x; i < wg::TILE_BYTES / 4; i += blockDim.x)
    reinterpret_cast<float*>(box)[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int g = threadIdx.x / 128;
  const uint32_t a = smem_addr(box);
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 16; ++j)
      wg::wgmma_tf32(d, wg::desc_k64(a + g * 4096 + (j & 1) * 32),
                     wg::desc_k64(a + (j & 1) * 32), 1);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
  }
  wg::wgmma_wait<0>();
  wg::reg_fence(d);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// The exact forms, on the prologue's planes qh/ql (Q, Dp), ch/cl (C, Dp)
// and norms qn (Q,), cn (C,). out_d / out_i: (C / c_tile, Q, k), C a
// multiple of c_tile (tiles), or (Q, k) (sweep).
int fused_knn_tiles_launch(const float* qh, const float* ql, const float* qn,
                           const float* ch, const float* cl, const float* cn,
                           float* out_d, int* out_i, int Q, int C, int Dp,
                           int m_corpus, int k, int c_tile, int exclude_self,
                           int exclude_zero, int all_pairs, float zero_eps,
                           cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || k <= 0 || c_tile <= 0 || C % c_tile) return (int)cudaErrorInvalidValue;
  Maps m;
  cudaError_t e = make_maps(&m, qh, ql, ch, cl, Q, C, Dp);
  if (e != cudaSuccess) return (int)e;
  const wg::TileItems walk{Q, C, c_tile, C < m_corpus ? C : m_corpus};
  const auto epi = exact_epi(walk, qn, cn, out_d, out_i, Q, Dp, k, exclude_self,
                             exclude_zero, all_pairs, zero_eps);
  const long long items = (long long)((Q + wg::ROWS - 1) / wg::ROWS) * (C / c_tile);
  LAUNCH_WG(fused_knn_tiles_kernel, m, epi, items, k, stream);
}

int fused_knn_sweep_launch(const float* qh, const float* ql, const float* qn,
                           const float* ch, const float* cl, const float* cn,
                           float* out_d, int* out_i, int Q, int C, int Dp,
                           int m_corpus, int k, int exclude_self, int exclude_zero,
                           int all_pairs, float zero_eps, cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  Maps m;
  cudaError_t e = make_maps(&m, qh, ql, ch, cl, Q, C, Dp);
  if (e != cudaSuccess) return (int)e;
  const wg::SweepItems walk{Q, C < m_corpus ? C : m_corpus};
  const auto epi = exact_epi(walk, qn, cn, out_d, out_i, Q, Dp, k, exclude_self,
                             exclude_zero, all_pairs, zero_eps);
  LAUNCH_WG(fused_knn_sweep_kernel, m, epi, (Q + wg::ROWS - 1) / wg::ROWS, k, stream);
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
           exclude_self, all_pairs};
  return (int)launch_compress(fused_knn_tiles_compress_kernel, p, C / c_tile, stream);
}

// K2[c] on the prologue's copies qb (Q, Dp), cb (C, Dp) and norms: the
// final (Q, k) over columns [0, min(C, m_corpus)) in `slices` corpus
// slices. With slices > 1, part_d / part_i are (slices, Q, k) scratch and
// counters (ceil(Q / 128),) int32 zeros (left at zero).
int fused_knn_sweep_compress_launch(const bf16* qb, const float* qn, const bf16* cb,
                                    const float* cn, float* out_d, int* out_i, float* part_d,
                                    int* part_i, int* counters, int Q, int C, int Dp,
                                    int m_corpus, int k, int exclude_self, int all_pairs,
                                    int slices, cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || k <= 0 || slices <= 0 || Dp % wgb::KB ||
      (slices > 1 && (part_d == nullptr || part_i == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, cm, nm;
  cudaError_t e = bf16_maps(&qm, &cm, qb, cb, Q, C, Dp);
  if (e == cudaSuccess) e = wgb::norms_map(&nm, cn, C);
  if (e != cudaSuccess) return (int)e;
  const wgb::SweepWalk walk = wgb::sweep_walk(Q, C < m_corpus ? C : m_corpus, slices);
  const CompressSweepEpi epi{walk, qn, cn, out_d, out_i, part_d, part_i, counters,
                             Q, k, Dp / wgb::KB, exclude_self && all_pairs};
  int grid = 0, per_sm = 0;
  e = wgb::tile_grid((const void*)fused_knn_sweep_compress_kernel, k, walk.items(), &grid,
                     &per_sm);
  if (e != cudaSuccess) return (int)e;
  fused_knn_sweep_compress_kernel<<<grid, wgb::THREADS, wgb::smem_bytes(k), stream>>>(qm, cm,
                                                                                     nm, epi);
  return (int)cudaGetLastError();
}

// K2[c]'s launch plan at (Q, C, m_corpus, k, slices): its items, the
// persistent grid, CTAs per SM, the columns a slice spans, the columns a
// chunk takes and the dynamic shared bytes.
int compress_sweep_plan(int Q, int C, int m_corpus, int k, int slices, long long* items,
                        int* grid, int* ctas_per_sm, int* span, int* cols, int* smem) {
  if (Q <= 0 || C <= 0 || k <= 0 || slices <= 0) return (int)cudaErrorInvalidValue;
  const wgb::SweepWalk walk = wgb::sweep_walk(Q, C < m_corpus ? C : m_corpus, slices);
  *items = walk.items();
  *span = walk.span;
  *cols = wgb::COLS;
  *smem = (int)wgb::smem_bytes(k);
  return (int)wgb::tile_grid((const void*)fused_knn_sweep_compress_kernel, k, *items, grid,
                             ctas_per_sm);
}

// The bf16 tile's raw products of the copies qb (Q, Dp), cb (C, Dp) over
// `slices` slices of the columns: out (Q, C) = qb . cb^T, or with `sink`
// the products alone (out holds one float, written only by chance).
int bf16_tile_dots_launch(const bf16* qb, const bf16* cb, float* out, int Q, int C, int Dp,
                          int slices, int sink, cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || slices <= 0 || Dp % wgb::KB) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, cm;
  cudaError_t e = bf16_maps(&qm, &cm, qb, cb, Q, C, Dp);
  if (e != cudaSuccess) return (int)e;
  const wgb::SweepWalk walk = wgb::sweep_walk(Q, C, slices);
  const Bf16DotsEpi epi{walk, out, Q, C, Dp / wgb::KB, 0, sink};
  int grid = 0, per_sm = 0;
  e = wgb::tile_grid((const void*)bf16_tile_dots_kernel, 0, walk.items(), &grid, &per_sm);
  if (e != cudaSuccess) return (int)e;
  bf16_tile_dots_kernel<<<grid, wgb::THREADS, wgb::smem_bytes(0), stream>>>(qm, cm, cm, epi);
  return (int)cudaGetLastError();
}

// The compress prologue: x (N, D) f32 -> out (N, Dp) bf16, norms (N,) f32.
int stage_bf16_f32_launch(const float* x, bf16* out, float* norms, int N,
                          int D, int Dp, cudaStream_t stream) {
  return (int)stage_bf16(F32Rows{x, D}, N, D, Dp, out, norms, stream);
}

// The exact prologue: x (N, D) f32 -> the planes hi, lo (N, Dp) f32 and
// norms (N,) f32 by the wgmma tile's product; Dp = D rounded up to 16.
int stage_tf32_split_launch(const float* x, float* hi, float* lo, float* norms, int N,
                            int D, int Dp, cudaStream_t stream) {
  return (int)wg::stage_split(F32Rows{x, D}, N, D, Dp, hi, lo, norms, stream);
}

// The wgmma tile's raw products of the planes: out (Q, C) = q . c^T (a
// test hook: the prologue's norms are its diagonal).
int split_tile_dots_launch(const float* qh, const float* ql, const float* ch,
                           const float* cl, float* out, int Q, int C, int Dp,
                           cudaStream_t stream) {
  if (Q <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  Maps m;
  cudaError_t e = make_maps(&m, qh, ql, ch, cl, Q, C, Dp);
  if (e != cudaSuccess) return (int)e;
  const DotsEpi epi{out, Q, C, Dp / wg::KB, 0};
  const long long items =
      (long long)((Q + wg::ROWS - 1) / wg::ROWS) * ((C + wg::COLS - 1) / wg::COLS);
  LAUNCH_WG(split_tile_dots_kernel, m, epi, items, 0, stream);
}

// The mma.sync tile's (K3a's, K4's, K5's) raw products: out (Q, C) = q . c^T
// (a test hook: the ring prologue's norms are its diagonal).
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

// The wgmma rate probe: out holds SMs * 256 floats; returns the FLOP it
// does (or a negative cudaError).
double wgmma_rate_launch(int iters, float* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess || iters <= 0) return -(double)(e ? e : cudaErrorInvalidValue);
  wgmma_rate_kernel<<<sms, wg::STAGE_THREADS, 0, stream>>>(out, iters);
  if ((e = cudaGetLastError()) != cudaSuccess) return -(double)e;
  // per warpgroup and round: 16 products of 64 x 128 x 8 multiply-adds
  return 2.0 * sms * 2 * (double)iters * 16 * 64 * 128 * 8;
}

// Registers, local (spilled) bytes a thread, CTAs per SM and dynamic shared
// bytes of kernel `which` (0 tiles, 1 sweep: the exact wgmma kernels; 2,
// 3 their compress forms: mma.sync K1[c], the bf16 wgmma K2[c]) at list
// width k.
int kernel_info(int which, int k, int* regs, int* local_bytes, int* ctas_per_sm, int* smem) {
  const void* kernels[] = {(const void*)fused_knn_tiles_kernel,
                           (const void*)fused_knn_sweep_kernel,
                           (const void*)fused_knn_tiles_compress_kernel,
                           (const void*)fused_knn_sweep_compress_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  if (which == 2) {
    *smem = (int)mma_smem_bytes(k);
    return (int)mma_kernel_info(kernels[which], k, regs, local_bytes, ctas_per_sm);
  }
  int grid = 0;
  cudaFuncAttributes attr;
  cudaError_t e = which == 3 ? wgb::tile_grid(kernels[which], k, 1, &grid, ctas_per_sm)
                             : wg::tile_grid(kernels[which], k, 1, &grid, ctas_per_sm);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernels[which]);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem = (int)(which == 3 ? wgb::smem_bytes(k) : wg::smem_bytes(k));
  return 0;
}

// The exact kernels' launch plan at (Q, C, c_tile, k): items (query groups,
// or query groups x corpus tiles), the persistent grid and CTAs per SM.
int exact_plan(int which, int Q, int C, int c_tile, int k, long long* items, int* grid,
               int* ctas_per_sm) {
  if (which < 0 || which > 1 || Q <= 0 || C <= 0 || c_tile <= 0) return (int)cudaErrorInvalidValue;
  const long long groups = (Q + wg::ROWS - 1) / wg::ROWS;
  *items = which == 0 ? groups * (C / c_tile) : groups;
  const void* kernel = which == 0 ? (const void*)fused_knn_tiles_kernel
                                  : (const void*)fused_knn_sweep_kernel;
  return (int)wg::tile_grid(kernel, k, *items, grid, ctas_per_sm);
}

}  // extern "C"

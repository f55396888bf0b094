// The bf16 sweep tile of K2[c], and of K1 / K2 at matmul_precision
// "default" / "high", for Hopper (sm_90a): bf16 `wgmma` on TMA-staged
// planes, the survivors filtered in registers, and the corpus split into
// slices when the query groups alone would leave SMs idle.
//
// The tile runs on P planes of each operand. P = 1: one bf16 copy, one
// pass (K2[c]'s compress copy; "default"'s copy rounded to nearest even).
// P = 2: "high"'s hi = bf16(x) and lo = bf16(x - hi); a chunk's k-blocks
// are streamed twice into the one f32 accumulator (no second one fits for
// promotion), first with four boxes a stage for the lo.hi and hi.lo
// passes, then the hi boxes of two k-blocks a stage for hi.hi, on a ring
// of 3 stages (chunk_product).
// The exact forms' epilogue adds the zero rule, checked where a marked key
// would win (ZeroRule), and primes an item's first chunk, whose every key
// would beat the empty lists: each row's 32 keys of its first 4 column
// groups are offered straight from registers and merged, so that the rest
// meets full lists (select_regs). K1's items are 8 chunks each, so their
// first chunks weigh (chip_smoke.py's item_cost line). K4 and K5 on the
// ring's f32 wire at "default" / "high" run the same tile
// (fused_ring_dma.cu's RingEpi): their items span several ranks' maps
// (walk_tile's maps_of), their columns mask by id (select_regs' mask), K4's
// transport runs on the producer's spare warps (walk_tile's side), and K5
// walks once a round, its ring's step count carried from round to round.
//
// Replaces, for K2[c] (mpi_knn_tpu/ops/pallas_knn.py::fused_knn_sweep with
// compress=True), knn_tile.cuh's `sweep_mma<Bf16x1>`, whose CTA stored all
// 128 x 128 keys of each chunk to a shared key tile and read them back
// behind a CTA barrier to offer them to the lists: more than 99.5 % of
// those stores and loads carried keys that lose, and no product ran while
// a chunk was selected. Here:
//
//   TMA + mbarrier ring. One producer thread (warpgroup 0) issues 2-D tiled
//   TMA loads (64-byte swizzle) of the CTA's 128 query rows and of the
//   chunk's COLS corpus rows, 32 bf16 deep (the same 64-byte box rows as
//   knn_wgmma.cuh's exact tile), into a ring of STAGES stages with
//   full/empty mbarriers. Its operands are the compress prologue's copies
//   (`stage_bf16_kernel`: rounded to nearest even, zero-padded to a
//   multiple of 32) and f32 norms, unchanged.
//
//   Two consumer warpgroups of 64 rows each issue wgmma.mma_async
//   m64n256k16 .f32.bf16.bf16, both operands K-major from shared memory,
//   two per k-block, into one f32 accumulator (128 registers a consumer
//   thread): a bf16 x bf16 product is exact in f32, so there are no planes
//   and no promotion. The CTA has 3 warps on each SM sub-partition, which caps
//   ptxas at 168 registers a thread whatever setmaxnreg grants, so the
//   selection keeps its state small: the accumulators become the keys in
//   place, and winners leave registers as they are found.
//
//   Selection in registers. In the wgmma accumulator layout a row's COLS
//   columns sit in one quad of one warp, so a warp owns 16 rows, their
//   lists (shared memory for k <= Ring<P>::KS, else rows of the caller's
//   buffer)
//   and a buffer of CAP winners a row. One pass turns each accumulator
//   into its key q^2 - 2 q.c + c^2 in place (clamped at 0; +inf where the
//   self or padding mask holds), with the chunk's column norms, which the
//   producer loads by TMA beside the chunk's last k-block (that stage is
//   released once the keys are formed), and marks in a bit mask the keys that beat their row's worst list entry by
//   (distance, column). Only the marked keys move: one a thread and row at
//   a time (read back by a tree of selects on its index, so the
//   accumulators never leave registers), checked against the current worst and appended to
//   the row's buffer at slots counted by quad shuffles. A full buffer is
//   merged into its list at once: a bitonic sort of its 32 entries and one
//   bitonic merge with the list's 64 slots (32 for k <= 32, two rows at a
//   time), all in warp shuffles. An
//   item's end merges what its buffers hold. No barrier wider than a warp,
//   so one warpgroup's selection may overlap the other's products.
//
//   Filling the card. An item is (query group x corpus slice); the caller
//   picks S slices (compress_sweep_plan) so that few query groups (a
//   serving bucket of 1024 rows is 8) still fill the SMs. One CTA per SM
//   walks the items slice-major, so the CTAs in flight share corpus
//   chunks in L2. With S > 1 each item's lists go to a scratch (S, Q, k);
//   the last CTA to finish a group's slices (a per-group counter, release
//   then acquire, left at zero) merges them by (distance, column) into the
//   output. A key's bits do not depend on its slice or CTA and the order
//   is total, so the output is the same bit for bit for every S.
//
// What bounds it: 2 Q C D FLOP at the dense bf16 peak. A chunk of 128 x 256
// reads (128 + 256) x 64 B per 32-deep k-block from L2, 85 FLOP/B (64 at
// 128 columns, which fed the product at ~450 TFLOP/s); the query box is
// re-read for every chunk. On an H100 the product alone (bf16_tile_dots)
// runs at ~690 TFLOP/s. The two warpgroups share the ring's stages, so
// they select in step and no product overlaps a selection: at the main
// shape the keys, the winners' moves and the merges add ~4 ms to the
// product's ~8 (chip_smoke.py's kernel_time and product_alone lines), and
// an item costs ~30 chunks' time beyond its own (compress_sweep_plan's
// ITEM_OVERHEAD_CHUNKS, fitted on the card).

#pragma once

#include <limits.h>

#include <type_traits>

#include "knn_wgmma.cuh"

namespace knn {
namespace wgb {

constexpr int ROWS = 128;            // query rows per CTA: two consumer warpgroups
constexpr int COLS = 256;            // columns per chunk: the wgmma's n
constexpr int KB = 32;               // bf16 per k-block: one 64-byte swizzled row
constexpr int Q_BOX = ROWS * KB * 2;
constexpr int C_BOX = COLS * KB * 2;
constexpr int N_BOX = COLS * 4;      // the chunk's column norms (f32)
constexpr int THREADS = 384;         // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ACC = COLS / 2;        // accumulator registers a consumer thread
constexpr int CAP = 32;              // a row's buffer of winners: one per lane
constexpr int FIRST_GROUPS = CAP / 8;  // an item's first chunk's offered groups of 8 columns

// The ring of a tile on P bf16 planes of each operand (1: one copy; 2: hi
// and lo): a stage holds the P query boxes, the P corpus boxes and the
// chunk's norms' slot, each 1 KB aligned. P = 1: 4 stages (100 KB); P = 2:
// 3 stages (147 KB), the lists then kept in shared memory up to KS = 40.
template <int P>
struct Ring {
  static constexpr int NORMS = P * (Q_BOX + C_BOX);  // the norms' slot
  static constexpr int STAGE_BYTES = NORMS + 1024;
  static constexpr int STAGES = (P == 1 ? 100 : 150) * 1024 / STAGE_BYTES;  // 4, 3
  static constexpr int KS = P == 1 ? 64 : 40;  // longest list kept in shared memory
};

// Shared memory of one CTA, from a 1024-byte aligned base: the ring, its
// barriers, the last-CTA flag, the rows' NaN flags and buffer counts, the
// buffers (per warp 16 rows x CAP) and the lists.
template <int P>
struct Layout {
  static constexpr int STAGES = Ring<P>::STAGES;
  static constexpr size_t bars = (size_t)STAGES * Ring<P>::STAGE_BYTES;  // full, empty
  static constexpr size_t flag = bars + 8 * 2 * STAGES;
  static constexpr size_t nanf = flag + 16;
  static constexpr size_t bufn = nanf + sizeof(int) * ROWS;
  static constexpr size_t cand = bufn + sizeof(int) * ROWS;
  static constexpr size_t lists = cand + (sizeof(float) + sizeof(int)) * ROWS * CAP;
  static constexpr size_t align = 1024;
};

template <int P = 1>
inline size_t smem_bytes(int k) {
  size_t b = Layout<P>::lists + Layout<P>::align;
  if (k <= Ring<P>::KS) b += (sizeof(float) + sizeof(int)) * (size_t)ROWS * k;
  return b;
}

// One item: query rows [q0, q0+ROWS) of query group `group` against
// columns [c_begin, c_end) of slice `slice`.
struct Item {
  int q0, c_begin, c_end, group, slice;
};

// The items of a sweep over Q query rows and columns [0, c_end) in
// `slices` slices of `span` columns (a multiple of COLS), slice-major.
struct SweepWalk {
  int Q, c_end, slices, span;
  __host__ __device__ int groups() const { return (Q + ROWS - 1) / ROWS; }
  __host__ __device__ int items() const { return groups() * slices; }
  __device__ Item item(int n) const {
    const int g = n % groups(), s = n / groups();
    const int c0 = s * span;
    return Item{g * ROWS, c0, min(c0 + span, c_end), g, s};
  }
};

// The walk of (Q, c_end) in S slices: span = the chunks rounded up per slice.
inline SweepWalk sweep_walk(int Q, int c_end, int slices) {
  const int chunks = c_end > 0 ? (c_end + COLS - 1) / COLS : 1;
  const int per = (chunks + slices - 1) / slices;
  return SweepWalk{Q, c_end, slices, per * COLS};
}

// What a consumer thread holds.
struct Ctx {
  float* Lsd;   // [ROWS][k] when k <= the ring's KS
  int* Lsi;
  int* nanf;    // [ROWS]
  int* bufn;    // [ROWS] winners buffered
  float* cd;    // this warp's buffers [16][CAP] (their ids: cand_ids(cd))
  int* flag;    // the CTA's last-CTA flag
  int g;        // consumer warpgroup (its 64 rows)
  int cwarp;    // consumer warp, 0..7: CTA rows 16 cwarp .. 16 cwarp + 15
  int lane;
  int ctid;     // consumer thread, 0..255
};

// A CTA's lists of k: the k entries of CTA row r at d(r), i(r); shared
// memory (sd, si) for k <= KS (Ring<P>::KS, at most 64: 2 slots a lane),
// else rows (row0 + r) of the caller's (rows, k) buffers (gd, gi). Two
// pointers and k, so that the selection keeps few registers.
template <int KS>
struct Lists {
  float* d0;
  int* i0;
  int k;
  __device__ static Lists at(float* sd, int* si, float* gd, int* gi, size_t row0, int k) {
    return k <= KS ? Lists{sd, si, k} : Lists{gd + row0 * k, gi + row0 * k, k};
  }
  __device__ float* d(int r) const { return d0 + r * k; }
  __device__ int* i(int r) const { return i0 + r * k; }
};

// ------------------------------------------------------------ primitives

// The ids of a warp's candidate buffers cd: the int half of the buffers,
// ROWS * CAP entries past the float half.
__device__ __forceinline__ int* cand_ids(float* cd) {
  return reinterpret_cast<int*>(cd + ROWS * CAP);
}

// d (+)= a . b for one warpgroup: a 64 x 16 bf16, b 256 x 16 bf16 (both
// K-major in shared memory); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int M>
__device__ __forceinline__ void reg_fence(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// f(std::integral_constant<int, i>) for i = 0 .. N-1: a loop whose index is
// a constant in every body, so register arrays indexed by it stay in
// registers however large the unrolled body grows.
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (N > 0) {
    static_for<N - 1>(f);
    f(std::integral_constant<int, N - 1>{});
  }
}

// A barrier of the two consumer warpgroups' 256 threads (named barrier 3).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// 1-D tiled TMA load of the box at c0 of `map` into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// The sweep's key: max(q^2 - 2 q.c + c^2, 0), keeping NaN; the plain
// version's rounding sequence.
__device__ __forceinline__ float sweep_key(float qs, float dot, float cs) {
  // qs - 2 dot by one fma: 2 dot is exact, so it rounds as __fsub_rn would
  const float d = __fadd_rn(__fmaf_rn(-2.f, dot, qs), cs);
  return d < 0.f ? 0.f : d;
}

// Inclusive prefix sum of v over the 4 lanes of a quad; total: the quad's sum.
__device__ __forceinline__ int quad_scan(int v, int lane, int& total) {
  int x = __shfl_up_sync(FULL, v, 1, 4);
  if (lane % 4 >= 1) v += x;
  x = __shfl_up_sync(FULL, v, 2, 4);
  if (lane % 4 >= 2) v += x;
  total = __shfl_sync(FULL, v, 3, 4);
  return v;
}

// (d, id) as one 64-bit key whose unsigned order is the lists' order by
// (distance, id), for d >= 0 or +inf (the keys never hold NaN or -0) and
// id >= -1 (ids shifted by one; INT_MAX pads above every real id).
__device__ __forceinline__ unsigned long long pack_key(float d, int id) {
  return (unsigned long long)__float_as_uint(d) << 32 | ((unsigned)id + 1u);
}
__device__ __forceinline__ float key_d(unsigned long long key) {
  return __uint_as_float((unsigned)(key >> 32));
}
__device__ __forceinline__ int key_id(unsigned long long key) {
  return (int)(unsigned)key - 1;
}

// One compare-exchange of a bitonic network across lanes `stride` apart:
// the lower lane keeps the smaller key when `ascending`.
__device__ __forceinline__ void bitonic_step(unsigned long long& key, int stride,
                                             bool ascending, int lane) {
  const unsigned long long other = __shfl_xor_sync(FULL, key, stride);
  const bool keep_min = ((lane & stride) == 0) == ascending;
  if (keep_min ? other < key : key < other) key = other;
}

// Merge n <= 32 candidates (cd, ci) into the ascending list (Ld, Li) of k;
// the whole warp takes part. k <= 64: the candidates are sorted (bitonic,
// one a lane; SORTED: they come sorted, from another list) and merged with
// the list's 64 slots (lane l: entries l and l + 32; past k, +inf) by one
// bitonic merge; the first k are kept. Else warp_offer inserts them one by
// one. SORTED also reads them past L1 (another CTA wrote them).
template <bool SORTED>
__device__ void merge_cands(float* Ld, int* Li, int k, const float* cd, const int* ci, int n,
                            int lane) {
  constexpr bool CG = SORTED;
  const bool act = lane < n;
  const float d = act ? (CG ? __ldcg(cd + lane) : cd[lane]) : inf_f();
  const int id = act ? (CG ? __ldcg(ci + lane) : ci[lane]) : INT_MAX;
  if (k > 64) {
    warp_offer(Ld, Li, k, d, id, act, lane);
    __syncwarp();
    return;
  }
  unsigned long long c = pack_key(d, id);
  if (!SORTED) {
#pragma unroll
    for (int size = 2; size <= 32; size *= 2)
#pragma unroll
      for (int stride = size / 2; stride > 0; stride /= 2)
        bitonic_step(c, stride, size == 32 || (lane & size) == 0, lane);
  }
  unsigned long long a0 = lane < k ? pack_key(Ld[lane], Li[lane]) : pack_key(inf_f(), INT_MAX);
  if (k <= 32) {  // the list's 32 slots alone: entry l against candidate 31 - l
    a0 = min(a0, __shfl_sync(FULL, c, 31 - lane));
#pragma unroll
    for (int stride = 16; stride > 0; stride /= 2) bitonic_step(a0, stride, true, lane);
    __syncwarp();
    if (lane < k) {
      Ld[lane] = key_d(a0);
      Li[lane] = key_id(a0);
    }
    __syncwarp();
    return;
  }
  unsigned long long a1 =
      lane + 32 < k ? pack_key(Ld[lane + 32], Li[lane + 32]) : pack_key(inf_f(), INT_MAX);
  // the 64 smallest of the list and the candidates, in bitonic order:
  // entry 32 + l against candidate 31 - l; then stride 32 within the lane
  a1 = min(a1, __shfl_sync(FULL, c, 31 - lane));
  const unsigned long long lo = min(a0, a1);
  a1 = max(a0, a1);
  a0 = lo;
#pragma unroll
  for (int stride = 16; stride > 0; stride /= 2) {
    bitonic_step(a0, stride, true, lane);
    bitonic_step(a1, stride, true, lane);
  }
  __syncwarp();  // every lane has read the list before it changes
  if (lane < k) {
    Ld[lane] = key_d(a0);
    Li[lane] = key_id(a0);
  }
  if (lane + 32 < k) {
    Ld[lane + 32] = key_d(a1);
    Li[lane + 32] = key_id(a1);
  }
  __syncwarp();
}

// Merge the buffers of the warp's rows ra and rb (rb < 0: none) into their
// lists of k <= 32, as merge_cands does one row, the two rows' networks
// interleaved so that each hides the other's shuffle latency.
template <class LT>
__device__ __forceinline__ void merge_two(const LT& L, int wrow0, int ra, int rb,
                                          const int* bufn, float* cd, int lane) {
  const int r[2] = {ra, rb}, k = L.k;
  const int* ci = cand_ids(cd);
  unsigned long long c[2], a[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool act = r[h] >= 0 && lane < bufn[wrow0 + max(r[h], 0)];
    c[h] = act ? pack_key(cd[r[h] * CAP + lane], ci[r[h] * CAP + lane])
               : pack_key(inf_f(), INT_MAX);
  }
#pragma unroll
  for (int size = 2; size <= 32; size *= 2)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bitonic_step(c[h], stride, size == 32 || (lane & size) == 0, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = r[h] >= 0 && lane < k
               ? pack_key(L.d(wrow0 + r[h])[lane], L.i(wrow0 + r[h])[lane])
               : pack_key(inf_f(), INT_MAX);
    a[h] = min(a[h], __shfl_sync(FULL, c[h], 31 - lane));
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride /= 2)
#pragma unroll
    for (int h = 0; h < 2; ++h) bitonic_step(a[h], stride, true, lane);
  __syncwarp();  // every lane has read the lists before they change
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (r[h] >= 0 && lane < k) {
      L.d(wrow0 + r[h])[lane] = key_d(a[h]);
      L.i(wrow0 + r[h])[lane] = key_id(a[h]);
    }
  __syncwarp();
}

// Merge the buffered winners of the warp's rows in `rows` (bit r: warp row
// r) into their lists and empty the buffers; lists of k <= 32 two rows at
// a time.
template <class LT>
__device__ __forceinline__ void flush_rows(unsigned rows, const LT& L, int wrow0, int* bufn,
                                           float* cd, int lane) {
  const int* ci = cand_ids(cd);
  while (rows) {
    const int r = __ffs(rows) - 1;
    rows &= rows - 1;
    int r2 = -1;
    if (L.k <= 32) {
      if (rows) {
        r2 = __ffs(rows) - 1;
        rows &= rows - 1;
      }
      merge_two(L, wrow0, r, r2, bufn, cd, lane);
    } else {
      merge_cands<false>(L.d(wrow0 + r), L.i(wrow0 + r), L.k, cd + r * CAP, ci + r * CAP,
                         bufn[wrow0 + r], lane);
    }
    __syncwarp();
    if (lane == 0) {
      bufn[wrow0 + r] = 0;
      if (r2 >= 0) bufn[wrow0 + r2] = 0;
    }
    __syncwarp();
  }
}

// Element re (0 .. N - 1 from LO, known only at run time) of row h of the
// accumulators, without taking their address (which would move them to
// local memory) and without a divergent branch: a tree of selects on the
// bits of re, depth first, so few values are live at once.
template <int LO, int N>
__device__ __forceinline__ float pick(const float (&a)[ACC], int h, int re) {
  if constexpr (N == 1) {
    return h ? a[4 * (LO / 2) + 2 + LO % 2] : a[4 * (LO / 2) + LO % 2];
  } else {
    const float lo = pick<LO, N / 2>(a, h, re), hi = pick<LO + N / 2, N / 2>(a, h, re);
    return (re & (N / 2)) ? hi : lo;
  }
}

// The exact forms' zero rule: a key d of column col in row norm qs is
// masked when d <= eps if eps > 0, else when d <= 1e-6 (qs + cn[col]).
// cn: the corpus norms in device memory; null: the rule is off. CG reads
// them past L1 (norms rewritten during the launch: K5's).
template <bool CG>
struct ZeroRuleOf {
  float eps;
  const float* cn;
  // the rule for a key whose column norm cs is at hand
  __device__ __forceinline__ bool masks_norm(float d, float qs, float cs) const {
    if (cn == nullptr) return false;
    return d <= (eps > 0.f ? eps : __fmul_rn(1e-6f, __fadd_rn(qs, cs)));
  }
  __device__ __forceinline__ bool masks(float d, float qs, int col) const {
    return cn != nullptr && masks_norm(d, qs, CG ? __ldcg(cn + col) : __ldg(cn + col));
  }
};
using ZeroRule = ZeroRuleOf<false>;

// The masks of a sweep's columns beyond the column range and the self
// column (col == row): none. A ring's columns (fused_ring_dma.cu) mask
// by their ids: id(col, c_end) is read once a column (below c_end), ok(id,
// h) says whether it stays valid for the thread's row h, and any(col0,
// c_end, lane), over the warp, whether the chunk at col0 may hold a column
// it masks for some row of the warp.
struct NoMask {
  __device__ __forceinline__ int id(int, int) const { return 0; }
  __device__ __forceinline__ bool ok(int, int) const { return true; }
  __device__ __forceinline__ bool any(int, int, int) const { return false; }
};

// The selection of one chunk for a consumer warp's 16 rows (CTA rows wrow0
// .. wrow0 + 15). acc: the wgmma accumulators of columns [col0, col0 +
// COLS); this thread holds rows wrow0 + lane/4 (h = 0) and + 8 (h = 1),
// global rows row[h] (live[h]: row[h] < Q) with norms qs[h]; cs: the
// chunk's column norms in shared memory, whose stage `release` frees once
// read. One pass turns each
// accumulator into its key (+inf where masked: columns at or past c_end,
// with `self` the column equal to the row), flags a row that meets a NaN
// key, and marks the keys that beat their row's worst list entry by
// (distance, column) in a bit mask. Then, one winner a thread and row at a
// time, the marked keys are checked against the current worst again and
// appended to the row's buffer (slots by quad shuffles); a buffer that
// fills is merged into its list before the rest are checked. With ZERO the
// zero rule `zero` masks a marked key at that check: a masked key is +inf,
// which never enters a list and is never NaN, so masking it only where it
// would win changes nothing else. `mask` adds the masks of a ring's
// columns by id (NoMask: none), checked where the keys are formed: in the
// first chunk and in a chunk that mask.any flags.
template <bool ZERO, class LT, class Z = ZeroRule, class M = NoMask>
__device__ __forceinline__ void select_regs(float (&acc)[ACC], int col0, int c_end,
                                            const int (&row)[2], const bool (&live)[2],
                                            const float (&qs)[2], bool self, const float* cs,
                                            uint32_t release, const LT& L, int wrow0,
                                            int* nanf, int* bufn, float* cd, int lane,
                                            const Z& zero, const M& mask = M{}) {
  int* const ci = cand_ids(cd);
  constexpr int E = ACC / 2, W = (E + 31) / 32;  // a row's elements in this thread
  const int cbase = col0 + 2 * (lane % 4), lr = lane / 4, k = L.k;
  float wd[2];
  int wi[2];
  auto worst = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow0 + lr + 8 * h;
      wd[h] = live[h] ? L.d(r)[k - 1] : -inf_f();
      wi[h] = live[h] ? L.i(r)[k - 1] : -1;
    }
  };
  worst();
  // element i = 4 j + 2 h + e: row h, its element 2 j + e, column cbase + 8 j + e
  bool nan[2] = {false, false};
  unsigned pm[2][W] = {};
  // the masks touch a chunk only at the corpus end, past Q, and (all
  // pairs) where its columns meet the warp's rows; elsewhere every key is
  // valid and a mark is the cheaper d <= worst (ties are checked again)
  const bool by_id = mask.any(col0, c_end, lane);  // the whole warp takes part
  const bool masked = __any_sync(
      FULL, col0 + COLS > c_end || !live[0] || !live[1] ||
                (self && ((row[0] >= col0 && row[0] < col0 + COLS) ||
                          (row[1] >= col0 && row[1] < col0 + COLS))) ||
                by_id);
  // An item's first chunk (with ZERO, the exact forms: a live row's list
  // empty, no winner buffered), where every key would win: the keys of its
  // first 4 column groups (8 a thread and row, 32 a row) are formed whole,
  // the zero rule included, offered straight from registers and merged at
  // once, so that each list holds its row's best of them before the rest
  // of the chunk is marked as any other chunk is.
  const bool first =
      ZERO &&
      __any_sync(FULL, (live[0] && wd[0] == inf_f()) || (live[1] && wd[1] == inf_f())) &&
      __all_sync(FULL, bufn[wrow0 + lr] == 0 && bufn[wrow0 + lr + 8] == 0);
  if (first) {
    int nb[2] = {0, 0};
    static_for<FIRST_GROUPS>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const int col = cbase + 8 * j;
      const float2 c2 = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * (lane % 4));
      const int id[2] = {mask.id(col, c_end), mask.id(col + 1, c_end)};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * j + x, h = x / 2, e = x % 2;
        const float c = e ? c2.y : c2.x;
        const float d = sweep_key(qs[h], acc[i], c);
        const bool valid = col + e < c_end && live[h] && !(self && col + e == row[h]) &&
                           mask.ok(id[e], h);
        nan[h] |= valid && d != d;
        acc[i] = valid && !zero.masks_norm(d, qs[h], c) ? d : inf_f();
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool win[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          win[h] = live[h] && lex_less(acc[4 * j + 2 * h + e], col + e, wd[h], wi[h]);
        int tot2;
        const int w2 = win[0] | win[1] << 16;
        const int off2 = quad_scan(w2, lane, tot2) - w2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slot = (lr + 8 * h) * CAP + nb[h] + ((off2 >> (16 * h)) & 0xffff);
          if (win[h]) {
            cd[slot] = acc[4 * j + 2 * h + e];
            ci[slot] = col + e;
          }
          nb[h] += (tot2 >> (16 * h)) & 0xffff;
        }
      }
    });
    const unsigned m0 = __ballot_sync(FULL, lane % 4 == 0 && nb[0] > 0);
    const unsigned m1 = __ballot_sync(FULL, lane % 4 == 0 && nb[1] > 0);
    unsigned rows = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      rows |= ((m0 >> (4 * q)) & 1u) << q | ((m1 >> (4 * q)) & 1u) << (q + 8);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane % 4 == 0) bufn[wrow0 + lr + 8 * h] = nb[h];
    __syncwarp();
    flush_rows(rows, L, wrow0, bufn, cd, lane);
    worst();
  }
  if (masked) {
    static_for<ACC / 4>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j < FIRST_GROUPS && first) return;  // offered above
      const int col = cbase + 8 * j;
      const float2 c2 = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * (lane % 4));
      const int id[2] = {mask.id(col, c_end), mask.id(col + 1, c_end)};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * j + x, h = x / 2, e = x % 2, re = 2 * j + e;
        const float d = sweep_key(qs[h], acc[i], e ? c2.y : c2.x);
        const bool valid = col + e < c_end && live[h] && !(self && col + e == row[h]) &&
                           mask.ok(id[e], h);
        nan[h] |= valid && d != d;
        acc[i] = valid ? d : inf_f();
        pm[h][re / 32] |= (unsigned)lex_less(acc[i], col + e, wd[h], wi[h]) << (re % 32);
      }
    });
  } else {
    // The keys stay unclamped here (a marked key is clamped when it moves;
    // a negative one is marked, as its clamped 0 may win). A NaN key makes
    // its row's sum of |key| NaN, and nothing else does, so one add a key
    // stands for the NaN check.
    float sum[2] = {0.f, 0.f};
    static_for<ACC / 4>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j < FIRST_GROUPS && first) return;  // offered above
      const float2 c2 = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * j + x, h = x / 2, e = x % 2, re = 2 * j + e;
        acc[i] = __fadd_rn(__fmaf_rn(-2.f, acc[i], qs[h]), e ? c2.y : c2.x);
        sum[h] = __fadd_rn(sum[h], fabsf(acc[i]));
        pm[h][re / 32] |= (unsigned)(acc[i] <= wd[h]) << (re % 32);
      }
    });
    nan[0] |= sum[0] != sum[0];
    nan[1] |= sum[1] != sum[1];
  }
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(release);  // the norms are read
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (nan[h]) nanf[wrow0 + lr + 8 * h] = 1;
  // the rows' buffer counts, held by their quads while the chunk is offered
  int nb[2] = {bufn[wrow0 + lr], bufn[wrow0 + lr + 8]};
  while (__any_sync(FULL, (pm[0][0] | pm[0][W - 1] | pm[1][0] | pm[1][W - 1]) != 0u)) {
    // this thread's next marked key of each row, checked again
    float d[2];
    int col[2], re[2];
    bool has[2], win[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      has[h] = (pm[h][0] | pm[h][W - 1]) != 0u;
      re[h] = pm[h][0] ? __ffs(pm[h][0]) - 1 : 32 * (W - 1) + __ffs(pm[h][W - 1]) - 1;
      col[h] = cbase + 8 * (re[h] / 2) + re[h] % 2;
      const float v = pick<0, ACC / 2>(acc, h, re[h]);  // unused when nothing is marked
      d[h] = v < 0.f ? 0.f : v;  // the clamp the unmasked key pass left out
      win[h] = has[h] && lex_less(d[h], col[h], wd[h], wi[h]);
      if constexpr (ZERO) win[h] = win[h] && !zero.masks(d[h], qs[h], col[h]);
    }
    // both rows' slots by one quad scan (row 0 in the low half)
    int tot2;
    const int off2 = quad_scan(win[0] | win[1] << 16, lane, tot2) - (win[0] | win[1] << 16);
    bool full[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (off2 >> (16 * h)) & 0xffff, tot = (tot2 >> (16 * h)) & 0xffff;
      const bool fits = win[h] && nb[h] + off < CAP;
      if (fits) {
        cd[(lr + 8 * h) * CAP + nb[h] + off] = d[h];
        ci[(lr + 8 * h) * CAP + nb[h] + off] = col[h];
      }
      if (has[h] && (fits || !win[h])) {  // taken, or beaten by the list: unmarked
        if (re[h] < 32) pm[h][0] &= ~(1u << re[h]);
        else pm[h][W - 1] &= ~(1u << (re[h] - 32));
      }
      nb[h] = min(CAP, nb[h] + tot);
      full[h] = live[h] && nb[h] == CAP;
    }
    // the rows whose buffer is full are merged now (lane 4 q holds rows q
    // and q + 8), and the worst entries read again
    if (__any_sync(FULL, full[0] || full[1])) {
      const unsigned m0 = __ballot_sync(FULL, lane % 4 == 0 && full[0]);
      const unsigned m1 = __ballot_sync(FULL, lane % 4 == 0 && full[1]);
      unsigned rows = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        rows |= ((m0 >> (4 * q)) & 1u) << q | ((m1 >> (4 * q)) & 1u) << (q + 8);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (lane % 4 == 0 && full[h]) bufn[wrow0 + lr + 8 * h] = CAP;
      __syncwarp();
      flush_rows(rows, L, wrow0, bufn, cd, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (full[h]) nb[h] = 0;
      worst();
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane % 4 == 0) bufn[wrow0 + lr + 8 * h] = nb[h];
  __syncwarp();
}

// ------------------------------------------------------------ the tile

// The ring stages of one chunk: its nkb k-blocks (P = 1), or (P = 2) its
// k-blocks with their lo passes, then their hi.hi two k-blocks a stage.
template <int P>
__host__ __device__ constexpr int chunk_steps(int nkb) {
  return P == 1 ? nkb : nkb + (nkb + 1) / 2;
}

// A consumer warpgroup's product of one chunk: acc = the sum of its ring
// stages it0 .. it0 + chunk_steps<P>(nkb) - 1. P = 1: the copies, two
// 16-deep wgmmas a k-block. P = 2: the chunk's k-blocks twice, first their
// lo.hi and hi.lo passes (four boxes a stage), then their hi.hi (the hi
// boxes of two k-blocks a stage, in the four slots): the small terms sum
// while the accumulators are small, and only the hi.hi terms round at the
// product's full size (no accumulator is left over for promotion: with
// each 16-deep step's three passes in turn, the sum of ~150 roundings at
// full size strayed past the precision gate of chip_smoke.py). Releases
// each stage but the last once its wgmmas have completed; the last holds
// the chunk's column norms, and the epilogue releases it.
template <int P>
__device__ __forceinline__ void chunk_product(float (&acc)[ACC], uint32_t ring, uint32_t full,
                                              uint32_t empty, uint32_t it0, int nkb, int g) {
  constexpr int STAGES = Ring<P>::STAGES;
  const bool signals = threadIdx.x % 32 == 0;
  for (int step = 0; step < chunk_steps<P>(nkb); ++step) {
    const uint32_t it = it0 + step, st = it % STAGES;
    wg::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const uint32_t stage = ring + st * Ring<P>::STAGE_BYTES;
    const uint32_t q = stage + g * 64 * 64, c = stage + P * Q_BOX;
    const uint32_t q2 = q + Q_BOX, c2 = c + C_BOX;  // P = 2: the second slots
    wg::wgmma_fence();
    if (P == 1 || step >= nkb) {  // the copies, or hi.hi
      wgmma_bf16(acc, wg::desc_k64(q), wg::desc_k64(c), step > 0 ? 1 : 0);
      wgmma_bf16(acc, wg::desc_k64(q + 32), wg::desc_k64(c + 32), 1);
      if (P == 2 && 2 * (step - nkb) + 1 < nkb) {  // the stage's second k-block
        wgmma_bf16(acc, wg::desc_k64(q2), wg::desc_k64(c2), 1);
        wgmma_bf16(acc, wg::desc_k64(q2 + 32), wg::desc_k64(c2 + 32), 1);
      }
    } else {  // lo.hi and hi.lo
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_bf16(acc, wg::desc_k64(q2 + 32 * h), wg::desc_k64(c + 32 * h),
                   step > 0 || h > 0 ? 1 : 0);
        wgmma_bf16(acc, wg::desc_k64(q + 32 * h), wg::desc_k64(c2 + 32 * h), 1);
      }
    }
    wg::wgmma_commit();
    if (step > 0) {
      wg::wgmma_wait<1>();
      if (signals) wg::mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
  }
  wg::wgmma_wait<0>();
  reg_fence(acc);
}

// The "default" / "high" planes of elements d0 .. d0 + 7 of the D-wide f32
// row x: hi = RNE(x) and, with lo non-null, lo = RNE(x - hi) (x - hi exact
// in f32), both zero past D, stored as 16 bytes at hi + at, lo + at. CG
// reads x past L1 (K5's slots, rewritten during its launch).
template <bool CG>
__device__ __forceinline__ void stage_planes8(const float* x, int D, int d0, bf16* hi, bf16* lo,
                                              size_t at) {
  alignas(16) bf16 h[8], l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = d0 + j < D ? (CG ? __ldcg(x + d0 + j) : x[d0 + j]) : 0.f;
    h[j] = __float2bfloat16_rn(v);
    l[j] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h[j])));
  }
  *reinterpret_cast<uint4*>(hi + at) = *reinterpret_cast<const uint4*>(h);
  if (lo != nullptr) *reinterpret_cast<uint4*>(lo + at) = *reinterpret_cast<const uint4*>(l);
}

// The tensor maps of an item: the query maps qm (and with two planes the
// lo plane's ql; boxes of KB x ROWS), the corpus maps cm (and cl; boxes of
// KB x COLS) and the corpus norms' map nm (boxes of COLS, or null: no
// norms).
struct TileMaps {
  const CUtensorMap *qm, *cm, *ql, *cl, *nm;
};

// The ring's mbarriers, once per launch (thread 0, then the whole CTA).
template <int P>
__device__ void init_ring(unsigned char* smem_raw) {
  using L = Layout<P>;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + (uint32_t)L::align - 1) & ~((uint32_t)L::align - 1);
  const uint32_t full = ring + (uint32_t)L::bars, empty = full + 8 * Ring<P>::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ring<P>::STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The tile's body after init_ring: the persistent walk of epi's items by
// one CTA of THREADS threads over Epi::planes planes, each item over the
// maps maps_of(item). Epi provides nkb (k-blocks), k, items(), item(n),
// and the consumers' hooks begin(item, ctx), chunk(acc, item, col0, norms,
// release, ctx), which arrives once a warp on `release` (the last stage's
// empty barrier) when done with the norms, and end(item, ctx). side(w)
// runs on warps w = 1..3 of the producer warpgroup, which issue no TMA.
// `it` is the ring's step count, held by the producer's thread 0 and by
// the consumers: a launch that walks again (K5's rounds) passes it on, and
// skips the register reallocation (SETREG false), which would have to be
// undone before the walk's threads meet again.
template <bool SETREG, class MapsOf, class Side, class Epi>
__device__ void walk_tile(const MapsOf& maps_of, const Side& side, const Epi& epi,
                          unsigned char* smem_raw, uint32_t& it) {
  constexpr int P = Epi::planes;
  using R = Ring<P>;
  using L = Layout<P>;
  constexpr int STAGES = R::STAGES;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + (uint32_t)L::align - 1) & ~((uint32_t)L::align - 1);
  unsigned char* base = smem_raw + (ring - raw);
  const uint32_t full = ring + (uint32_t)L::bars, empty = full + 8 * STAGES;
  const int items = epi.items();
  if (threadIdx.x < 128) {  // producer warpgroup
    if (SETREG) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int n = blockIdx.x; n < items; n += gridDim.x) {
        const Item t = epi.item(n);
        const TileMaps m = maps_of(t);
        for (int col0 = t.c_begin; col0 < t.c_end; col0 += COLS)
          for (int step = 0; step < chunk_steps<P>(epi.nkb); ++step, ++it) {
            // P = 2: the lo passes' stages (kb's four boxes), then hi.hi's
            // (the hi boxes of kb and kb + 1, in the stage's four slots)
            const bool lo = P == 2 && step < epi.nkb;
            const int kb = P == 1 || lo ? step : 2 * (step - epi.nkb);
            const bool second = P == 2 && (lo || kb + 1 < epi.nkb);
            const CUtensorMap* q2 = lo ? m.ql : m.qm;
            const CUtensorMap* c2 = lo ? m.cl : m.cm;
            const int kb2 = lo ? kb : kb + 1;
            const uint32_t st = it % STAGES;
            wg::mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
            const uint32_t bar = full + 8 * st, dst = ring + st * R::STAGE_BYTES;
            const bool norms = m.nm != nullptr && step == chunk_steps<P>(epi.nkb) - 1;
            wg::mbar_expect_tx(bar, (second ? 2 : 1) * (Q_BOX + C_BOX) + (norms ? N_BOX : 0));
            wg::tma_load(dst, m.qm, bar, kb * KB, t.q0);
            wg::tma_load(dst + P * Q_BOX, m.cm, bar, kb * KB, col0);
            if (second) {
              wg::tma_load(dst + Q_BOX, q2, bar, kb2 * KB, t.q0);
              wg::tma_load(dst + 2 * Q_BOX + C_BOX, c2, bar, kb2 * KB, col0);
            }
            if (norms) tma_load_1d(dst + R::NORMS, m.nm, bar, col0);
          }
      }
    } else if (threadIdx.x >= 32) {
      side(threadIdx.x / 32);
    }
    return;
  }
  if (SETREG) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  Ctx ctx;
  ctx.ctid = threadIdx.x - 128;
  ctx.g = ctx.ctid / 128;
  ctx.cwarp = ctx.ctid / 32;
  ctx.lane = ctx.ctid % 32;
  ctx.flag = reinterpret_cast<int*>(base + L::flag);
  ctx.nanf = reinterpret_cast<int*>(base + L::nanf);
  ctx.bufn = reinterpret_cast<int*>(base + L::bufn);
  ctx.cd = reinterpret_cast<float*>(base + L::cand) + ctx.cwarp * 16 * CAP;
  ctx.Lsd = reinterpret_cast<float*>(base + L::lists);
  ctx.Lsi = reinterpret_cast<int*>(ctx.Lsd + (epi.k <= R::KS ? ROWS * epi.k : 0));
  float acc[ACC];
  for (int n = blockIdx.x; n < items; n += gridDim.x) {
    const Item t = epi.item(n);
    epi.begin(t, ctx);
    for (int col0 = t.c_begin; col0 < t.c_end; col0 += COLS) {
      chunk_product<P>(acc, ring, full, empty, it, epi.nkb, ctx.g);
      it += chunk_steps<P>(epi.nkb);
      const uint32_t last = (it - 1) % STAGES;
      epi.chunk(acc, t, col0,
                reinterpret_cast<const float*>(base + last * R::STAGE_BYTES + R::NORMS),
                empty + 8 * last, ctx);
    }
    epi.end(t, ctx);
  }
}

// The tile of one launch over one set of maps (see TileMaps), nothing on
// the producer's spare warps.
template <class Epi>
__device__ void run_tile(const CUtensorMap* qm, const CUtensorMap* cm, const CUtensorMap* ql,
                         const CUtensorMap* cl, const CUtensorMap* nm, const Epi& epi,
                         unsigned char* smem_raw) {
  init_ring<Epi::planes>(smem_raw);
  uint32_t it = 0;
  walk_tile<true>([=](const Item&) { return TileMaps{qm, cm, ql, cl, nm}; },
                  [](int) {}, epi, smem_raw, it);
}

// ------------------------------------------------------------ host side

// The tensor map of a bf16 row set (rows, Dp): boxes of KB x box_rows,
// 64-byte swizzle, rows past the set read as zeros.
inline cudaError_t bf16_map(CUtensorMap* map, const void* x, int rows, int Dp, int box_rows) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(x) & 15) || Dp % KB || rows <= 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)Dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Dp * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)box_rows}, step[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of an f32 vector (n,): boxes of COLS, no swizzle, entries
// past n read as zeros.
inline cudaError_t norms_map(CUtensorMap* map, const float* x, int n) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(x) & 15) || n <= 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};  // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)COLS}, step[1] = {1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(x), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The persistent grid of a kernel of this tile on P planes: min(items, SMs
// x CTAs per SM).
template <int P = 1>
inline cudaError_t tile_grid(const void* kernel, int k, long long items, int* grid,
                             int* ctas_per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes<P>(k));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, THREADS,
                                                      smem_bytes<P>(k));
  if (e != cudaSuccess) return e;
  if (*ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * *ctas_per_sm;
  *grid = (int)(items < slots ? items : slots);
  return cudaSuccess;
}

}  // namespace wgb
}  // namespace knn

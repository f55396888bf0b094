// The compress sweep tile of K2[c] for Hopper (sm_90a): one bf16 `wgmma`
// pass on TMA-staged copies, the survivors filtered in registers, and the
// corpus split into slices when the query groups alone would leave SMs
// idle.
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
//   lists (shared memory for k <= KS, else rows of the caller's buffer)
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
//   bitonic merge with the list's 64 slots, all in warp shuffles. An
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
constexpr int STAGE_BYTES = Q_BOX + C_BOX + 1024;  // + the norms' slot, 1 KB aligned
constexpr int STAGES = 100 * 1024 / STAGE_BYTES;  // 4
constexpr int THREADS = 384;         // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ACC = COLS / 2;        // accumulator registers a consumer thread
constexpr int KS = 64;               // longest list kept in shared memory (2 slots a lane)
constexpr int CAP = 32;              // a row's buffer of winners: one per lane

// Shared memory of one CTA, from a 1024-byte aligned base: the ring, its
// barriers, the last-CTA flag, the rows' NaN flags and buffer counts, the
// buffers (per warp 16 rows x CAP) and the lists.
struct Layout {
  static constexpr size_t bars = (size_t)STAGES * STAGE_BYTES;  // full, empty
  static constexpr size_t flag = bars + 8 * 2 * STAGES;
  static constexpr size_t nanf = flag + 16;
  static constexpr size_t bufn = nanf + sizeof(int) * ROWS;
  static constexpr size_t cand = bufn + sizeof(int) * ROWS;
  static constexpr size_t lists = cand + (sizeof(float) + sizeof(int)) * ROWS * CAP;
  static constexpr size_t align = 1024;
};

inline size_t smem_bytes(int k) {
  size_t b = Layout::lists + Layout::align;
  if (k <= KS) b += (sizeof(float) + sizeof(int)) * (size_t)ROWS * k;
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
  float* Lsd;   // [ROWS][k] when k <= KS
  int* Lsi;
  int* nanf;    // [ROWS]
  int* bufn;    // [ROWS] winners buffered
  float* cd;    // this warp's buffers [16][CAP]
  int* ci;
  int* flag;    // the CTA's last-CTA flag
  int g;        // consumer warpgroup (its 64 rows)
  int cwarp;    // consumer warp, 0..7: CTA rows 16 cwarp .. 16 cwarp + 15
  int lane;
  int ctid;     // consumer thread, 0..255
};

// A CTA's lists: shared memory for k <= KS, else rows (row0 + r) of the
// caller's (rows, k) buffers.
struct Lists {
  float* sd;
  int* si;
  float* gd;
  int* gi;
  size_t row0;
  int k;
  __device__ float* d(int r) const {
    return k <= KS ? sd + r * k : gd + (row0 + r) * (size_t)k;
  }
  __device__ int* i(int r) const {
    return k <= KS ? si + r * k : gi + (row0 + r) * (size_t)k;
  }
};

// ------------------------------------------------------------ primitives

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

// Merge the buffered winners of the warp's rows in `rows` (bit r: warp row
// r) into their lists and empty the buffers.
template <class LT>
__device__ __forceinline__ void flush_rows(unsigned rows, const LT& L, int wrow0, int* bufn,
                                           float* cd, int* ci, int lane) {
  while (rows) {
    const int r = __ffs(rows) - 1;
    rows &= rows - 1;
    merge_cands<false>(L.d(wrow0 + r), L.i(wrow0 + r), L.k, cd + r * CAP, ci + r * CAP,
                       bufn[wrow0 + r], lane);
    if (lane == 0) bufn[wrow0 + r] = 0;
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
// fills is merged into its list before the rest are checked.
template <class LT>
__device__ __forceinline__ void select_regs(float (&acc)[ACC], int col0, int c_end,
                                            const int (&row)[2], const bool (&live)[2],
                                            const float (&qs)[2], bool self, const float* cs,
                                            uint32_t release, const LT& L, int wrow0,
                                            int* nanf, int* bufn, float* cd, int* ci,
                                            int lane) {
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
  const bool masked = __any_sync(
      FULL, col0 + COLS > c_end || !live[0] || !live[1] ||
                (self && ((row[0] >= col0 && row[0] < col0 + COLS) ||
                          (row[1] >= col0 && row[1] < col0 + COLS))));
  if (masked) {
    static_for<ACC / 4>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const int col = cbase + 8 * j;
      const float2 c2 = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * j + x, h = x / 2, e = x % 2, re = 2 * j + e;
        const float d = sweep_key(qs[h], acc[i], e ? c2.y : c2.x);
        const bool valid = col + e < c_end && live[h] && !(self && col + e == row[h]);
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
      const float2 c2 = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * j + x, h = x / 2, e = x % 2, re = 2 * j + e;
        acc[i] = __fadd_rn(__fmaf_rn(-2.f, acc[i], qs[h]), e ? c2.y : c2.x);
        sum[h] = __fadd_rn(sum[h], fabsf(acc[i]));
        pm[h][re / 32] |= (unsigned)(acc[i] <= wd[h]) << (re % 32);
      }
    });
    nan[0] = sum[0] != sum[0];
    nan[1] = sum[1] != sum[1];
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
      flush_rows(rows, L, wrow0, bufn, cd, ci, lane);
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

// A consumer warpgroup's product of one chunk: acc = the sum over the
// chunk's nkb k-blocks (ring stages it0 .. it0 + nkb - 1) of two 16-deep
// wgmmas each. Releases each stage but the last once its wgmmas have
// completed; the last holds the chunk's column norms, and the epilogue
// releases it.
__device__ __forceinline__ void chunk_product(float (&acc)[ACC], uint32_t ring, uint32_t full,
                                              uint32_t empty, uint32_t it0, int nkb, int g) {
  const bool signals = threadIdx.x % 32 == 0;
  for (int kb = 0; kb < nkb; ++kb) {
    const uint32_t it = it0 + kb, st = it % STAGES;
    wg::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const uint32_t stage = ring + st * STAGE_BYTES;
    const uint32_t q = stage + g * 64 * 64, c = stage + Q_BOX;
    wg::wgmma_fence();
    wgmma_bf16(acc, wg::desc_k64(q), wg::desc_k64(c), kb > 0 ? 1 : 0);
    wgmma_bf16(acc, wg::desc_k64(q + 32), wg::desc_k64(c + 32), 1);
    wg::wgmma_commit();
    if (kb > 0) {
      wg::wgmma_wait<1>();
      if (signals) wg::mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
  }
  wg::wgmma_wait<0>();
  reg_fence(acc);
}

// The tile's body: the persistent walk of epi's items by one CTA of THREADS
// threads over the query map qm (boxes of KB x ROWS), the corpus map cm
// (boxes of KB x COLS) and the corpus norms' map nm (boxes of COLS, or
// null: no norms). Epi provides nkb (k-blocks), k, items(), item(n), and
// the consumers' hooks begin(item, ctx), chunk(acc, item, col0, norms,
// release, ctx), which arrives once a warp on `release` (the last stage's
// empty barrier) when done with the norms, and end(item, ctx).
template <class Epi>
__device__ void run_tile(const CUtensorMap* qm, const CUtensorMap* cm, const CUtensorMap* nm,
                         const Epi& epi, unsigned char* smem_raw) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + (uint32_t)Layout::align - 1) & ~((uint32_t)Layout::align - 1);
  unsigned char* base = smem_raw + (ring - raw);
  const uint32_t full = ring + (uint32_t)Layout::bars, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int items = epi.items();
  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int n = blockIdx.x; n < items; n += gridDim.x) {
        const Item t = epi.item(n);
        for (int col0 = t.c_begin; col0 < t.c_end; col0 += COLS)
          for (int kb = 0; kb < epi.nkb; ++kb, ++it) {
            const uint32_t st = it % STAGES;
            wg::mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
            const uint32_t bar = full + 8 * st, dst = ring + st * STAGE_BYTES;
            const bool norms = nm != nullptr && kb == epi.nkb - 1;
            wg::mbar_expect_tx(bar, Q_BOX + C_BOX + (norms ? N_BOX : 0));
            wg::tma_load(dst, qm, bar, kb * KB, t.q0);
            wg::tma_load(dst + Q_BOX, cm, bar, kb * KB, col0);
            if (norms) tma_load_1d(dst + Q_BOX + C_BOX, nm, bar, col0);
          }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  Ctx ctx;
  ctx.ctid = threadIdx.x - 128;
  ctx.g = ctx.ctid / 128;
  ctx.cwarp = ctx.ctid / 32;
  ctx.lane = ctx.ctid % 32;
  ctx.flag = reinterpret_cast<int*>(base + Layout::flag);
  ctx.nanf = reinterpret_cast<int*>(base + Layout::nanf);
  ctx.bufn = reinterpret_cast<int*>(base + Layout::bufn);
  ctx.cd = reinterpret_cast<float*>(base + Layout::cand) + ctx.cwarp * 16 * CAP;
  ctx.ci = reinterpret_cast<int*>(base + Layout::cand + sizeof(float) * ROWS * CAP) +
           ctx.cwarp * 16 * CAP;
  ctx.Lsd = reinterpret_cast<float*>(base + Layout::lists);
  ctx.Lsi = reinterpret_cast<int*>(ctx.Lsd + (epi.k <= KS ? ROWS * epi.k : 0));
  float acc[ACC];
  uint32_t it = 0;
  for (int n = blockIdx.x; n < items; n += gridDim.x) {
    const Item t = epi.item(n);
    epi.begin(t, ctx);
    for (int col0 = t.c_begin; col0 < t.c_end; col0 += COLS) {
      chunk_product(acc, ring, full, empty, it, epi.nkb, ctx.g);
      it += epi.nkb;
      const uint32_t last = (it - 1) % STAGES;
      epi.chunk(acc, t, col0,
                reinterpret_cast<const float*>(base + last * STAGE_BYTES + Q_BOX + C_BOX),
                empty + 8 * last, ctx);
    }
    epi.end(t, ctx);
  }
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

// The persistent grid of a kernel of this tile: min(items, SMs x CTAs per SM).
inline cudaError_t tile_grid(const void* kernel, int k, long long items, int* grid,
                             int* ctas_per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(k));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, THREADS,
                                                      smem_bytes(k));
  if (e != cudaSuccess) return e;
  if (*ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * *ctas_per_sm;
  *grid = (int)(items < slots ? items : slots);
  return cudaSuccess;
}

}  // namespace wgb
}  // namespace knn

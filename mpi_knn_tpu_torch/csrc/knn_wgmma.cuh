// The exact tile of the fused kNN kernels K1 and K2, and of the ring round
// K4 on the f32 wire, for Hopper (sm_90a): `wgmma` TF32 x3 on TMA-staged
// hi/lo planes, warp-specialised.
//
// Replaces, for K1/K2's exact form and K4's f32 form, knn_tile.cuh's
// `sweep_mma<Tf32x3>`, whose k-loop split every f32 operand in registers
// after each fragment load and promoted each k-step's partial with FADDs
// on the same issue slots as its synchronous mma.sync. Here:
//
//   Split once. The prologue `stage_split_kernel` writes each row set once
//   as two planes, hi = tf32_rna(x) and lo = tf32_rna(x - hi) (hi by cvt,
//   so a NaN row stays NaN), zero-padded to a pitch Dp, a multiple of the
//   16-float k-block, with the squared norms beside them (below).
//
//   TMA + mbarrier ring. One producer thread (warpgroup 0) issues 2-D tiled
//   TMA loads (64-byte swizzle) of the hi and lo boxes of the CTA's 128
//   query rows and of the 128-column chunk, 16 floats deep, into a ring of
//   STAGES stages (32 KB each) with full/empty mbarriers. The key tile does
//   not alias the ring, so the producer fetches the next chunk while the
//   consumers select.
//
//   Two consumer warpgroups of 64 rows each issue wgmma.mma_async
//   m64n128k8 .f32.tf32.tf32, both operands K-major from shared memory, per
//   8-deep k-step in the order lo.hi, hi.lo, hi.hi. setmaxnreg gives the
//   registers to the consumers (PRODUCER_REGS / CONSUMER_REGS).
//
//   Promotion off the issue path. The products of one promotion interval
//   (PROMOTE k-steps, the build constant KNN_WGMMA_PROMOTE: 1, 2 or 4 = 8,
//   16 or 32 deep; 0 = the whole chunk, no promotion) go into a zeroed
//   wgmma partial; after wgmma.wait_group the partial is added to the sum
//   with one __fadd_rn per element. Two partials alternate, so the FADDs of
//   one interval overlap the next interval's asynchronous wgmmas. The
//   default, 16 deep, was chosen from chip_smoke.py's exact_error_interval
//   on an H100: max |d - d_f64| / (q^2 + c^2) 5.3e-7 at 16, 7.7e-7 at 8,
//   4.3e-7 at 32 (which holds two of the four stages per partial and
//   starves the ring: ~20 % slower), 2.7e-6 without promotion, against the
//   zero rule's 1e-6. K4 (fused_ring_dma.cu, its own build) takes 8 deep:
//   there the products and the prologue's norms equal the mma.sync Tf32x3
//   tile's bit for bit (chip_smoke.py's wgmma_8deep_vs_mma_sync), so its
//   ring equals the K3a and K5 rings bit for bit.
//
//   Exact duplicates at exactly 0. The prologue takes each row's norm as
//   the diagonal of its 128-row group's product with itself, by the same
//   wgmma shape, pass order and promotion intervals; so an exact duplicate
//   pair gives q^2 - 2 q.c + c^2 == 0 bit for bit, given that the tensor
//   cores give an element the same bits at any row and column of a wgmma
//   tile (the card tests check this with `split_tile_dots`).
//
//   Keys and selection (the caller's hooks, `Epi`). The exact kernels'
//   compute q^2 - 2 q.c + c^2 from the wgmma accumulator layout, apply the
//   masks, write the key tile and run knn_tile.cuh's selection
//   (`select_chunk`); each consumer warpgroup keys and selects its own 64
//   rows and syncs only with itself. Lists of k <= KS live in shared
//   memory, longer ones in the caller's output rows.
//
//   Filling the card. One CTA per SM (the ring and key tile take ~198 KB)
//   walks the caller's items (`Epi::items`, `Epi::item`) in a persistent
//   grid of min(items, SMs) CTAs; an item names the tensor maps it reads
//   (run_tile_of's maps_of: K4's items span several ranks' planes), and
//   the producer warpgroup's three warps that issue no TMA run the caller's
//   side work (K4's transport).
//
// What bounds it: 3 x 2 Q C D FLOP at the dense TF32 peak. Every 128 x 128
// chunk reads 2 KB of hi + lo per k-column from L2 for 98304 FLOP (48
// FLOP/B), so at the TF32 peak the L2 would have to deliver ~10 TB/s; the
// product alone (split_tile_dots, chip_smoke.py's product_alone) runs at
// under half the peak, whether the operands fit in L2 or not.

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (the driver entry point)

#include "knn_tile.cuh"

#ifndef KNN_WGMMA_PROMOTE
#define KNN_WGMMA_PROMOTE 2
#endif

namespace knn {
namespace wg {

constexpr int ROWS = 128;           // query rows per CTA: two consumer warpgroups
constexpr int COLS = MCB;           // columns per chunk: the wgmma's n
constexpr int KB = 16;              // f32 per k-block: one 64-byte swizzled row
constexpr int STAGES = 4;           // TMA ring
constexpr int THREADS = 384;        // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;  // each arrives once on an empty barrier
constexpr int PROMOTE = KNN_WGMMA_PROMOTE;  // k-steps per promotion interval
constexpr int TILE_BYTES = ROWS * KB * 4;   // one plane's box: 128 rows x 64 B
constexpr int STAGE_BYTES = 4 * TILE_BYTES; // q hi, q lo, c hi, c lo
constexpr int KS = 32;              // longest list kept in shared memory
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGE_THREADS = 256;  // the prologue: the two consumer warpgroups' shape
static_assert(PROMOTE == 0 || PROMOTE == 1 || PROMOTE == 2 || PROMOTE == 4,
              "KNN_WGMMA_PROMOTE: 0, 1, 2 or 4 k-steps");
static_assert(COLS == 128 && ROWS == 128, "m64n128 per consumer warpgroup");

// Shared memory of one tile CTA, from a 1024-byte aligned base.
struct Layout {
  static constexpr size_t ds = (size_t)STAGES * STAGE_BYTES;         // key tile
  static constexpr size_t bars = ds + sizeof(float) * ROWS * MDS;    // full, empty
  static constexpr size_t nanf = bars + 8 * 2 * STAGES;
  static constexpr size_t lists = nanf + sizeof(int) * ROWS;
  static constexpr size_t align = 1024;
};

inline size_t smem_bytes(int k) {
  size_t b = Layout::lists + Layout::align;
  if (k <= KS) b += (sizeof(float) + sizeof(int)) * (size_t)ROWS * k;
  return b;
}

// One item of a CTA's walk: query rows [q0, q0+ROWS) against columns
// [c_begin, c_end); out_row0 is the item's first output row.
struct Item {
  int q0, c_begin, c_end;
  size_t out_row0;
  int part = 0;  // which of the caller's operand sets (a ring rank)
};

// The four planes' tensor maps an item reads: queries hi, lo, columns hi, lo.
struct TileMaps {
  const CUtensorMap *qh, *ql, *ch, *cl;
};

// What the consumers hold for an item's epilogue.
struct Ctx {
  float* Ds;    // [ROWS][MDS] keys
  int* nanf;    // [ROWS]
  float* Lsd;   // [ROWS][k] when k <= KS
  int* Lsi;
  int g;        // consumer warpgroup (its 64 rows)
  int cwarp;    // consumer warp, 0..7
  int lane;
};

// An item's lists: shared memory for k <= KS, else rows of the caller's
// (rows, k) output buffers.
struct WgLists {
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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Wait for the phase of parity `parity` to complete. The spin lives in
// one asm block, so the compiler sees no divergent loop around the wgmmas
// that follow. Bounded: a pipeline that has not moved for 5 s traps, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done, more;\n.reg .u64 t0, t;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni DONE;\n"
      "mov.u64 t, %%globaltimer;\n"
      "sub.u64 t, t, t0;\n"
      "setp.lt.u64 more, t, 5000000000;\n"
      "@more bra.uni WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 2-D tiled TMA load of the box at (c0 along the row, c1 rows) of `map`
// into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The shared-memory descriptor of a K-major operand in the 64-byte swizzle
// (rows of 64 B, 8-row atoms of 512 B: SBO 512 B, LBO unused), starting at
// `saddr` (the k-step's byte offset within the row already added).
__device__ __forceinline__ uint64_t desc_k64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// The byte offset, in a 64-byte-swizzled box of 16 f32 per row, of row r,
// element kk: 16-byte chunk c of row r lies at chunk c ^ ((r >> 1) & 3).
__device__ __forceinline__ uint32_t swz64(int r, int kk) {
  return r * 64 + ((((kk >> 2) ^ (r >> 1)) & 3) << 4) + (kk & 3) * 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of d across a wgmma wait.
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . b for one warpgroup: a 64 x 8 tf32 (K-major), b 128 x 8 tf32
// (K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The three passes of one 8-deep k-step, lo.hi, hi.lo, hi.hi, into P:
// warpgroup g's 64 query rows of the boxes at qh/ql against the 128
// columns of the boxes at ch/cl, k-step `half` (0 or 1) of the k-block.
// `first` starts a promotion interval (P is overwritten).
__device__ __forceinline__ void kstep3(float (&P)[64], uint32_t qh, uint32_t ql,
                                       uint32_t ch, uint32_t cl, int g, int half,
                                       bool first) {
  const uint32_t ao = g * 64 * 64 + half * 32, bo = half * 32;
  wgmma_tf32(P, desc_k64(ql + ao), desc_k64(ch + bo), first ? 0 : 1);
  wgmma_tf32(P, desc_k64(qh + ao), desc_k64(cl + bo), 1);
  wgmma_tf32(P, desc_k64(qh + ao), desc_k64(ch + bo), 1);
}

__device__ __forceinline__ void promote(float (&acc)[64], const float (&P)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], P[i]);
}

// Whether k-step s starts / ends a promotion interval of a chunk of nks.
__device__ __forceinline__ bool interval_starts(int s) {
  return PROMOTE == 0 ? s == 0 : s % PROMOTE == 0;
}
__device__ __forceinline__ bool interval_ends(int s, int nks) {
  return s == nks - 1 || (PROMOTE != 0 && s % PROMOTE == PROMOTE - 1);
}

// Accumulator element i of thread (warp w of its warpgroup, lane l) sits at
// row 16 w + l/4 + 8 ((i % 4) / 2), column 8 (i / 4) + 2 (l % 4) + i % 2 of
// the warpgroup's 64 x 128 tile.
__device__ __forceinline__ int acc_row(int w, int lane, int i) {
  return 16 * w + lane / 4 + 8 * ((i % 4) / 2);
}
__device__ __forceinline__ int acc_col(int lane, int i) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// ------------------------------------------------------------ the tile

// A consumer warpgroup's product of one chunk: acc = the sum over the
// chunk's nkb k-blocks (ring stages it0 .. it0 + nkb - 1) of the three
// passes, promoted interval by interval through the partials p0 / p1.
// Releases each stage to the producer once its wgmmas have completed.
__device__ __forceinline__ void chunk_product(float (&acc)[64], float (&p0)[64],
                                              float (&p1)[64], uint32_t ring,
                                              uint32_t full, uint32_t empty, uint32_t it0,
                                              int nkb, int g) {
  const int nks = 2 * nkb;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0, released = 0;
  // stages whose k-steps all lie before `done` go back to the producer:
  // one arrival per warp, once its wgmmas (the group's) have completed
  const bool signals = threadIdx.x % 32 == 0;
  auto release = [&](int done) {
    for (; 2 * (released + 1) <= done; ++released)
      if (signals) mbar_arrive(empty + 8 * ((it0 + released) % STAGES));
  };
  // the wgmmas of one interval from k-step s into P, committed as a group.
  // An interval longer than the ring (PROMOTE 0) waits for each k-block's
  // wgmmas and frees its stage before the next one.
  auto issue = [&](float (&P)[64]) {
    wgmma_fence();
    do {
      const uint32_t it = it0 + (s >> 1), st = it % STAGES;
      if ((s & 1) == 0) mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const uint32_t base = ring + st * STAGE_BYTES;
      kstep3(P, base, base + TILE_BYTES, base + 2 * TILE_BYTES, base + 3 * TILE_BYTES, g,
             s & 1, interval_starts(s));
      ++s;
      if (PROMOTE == 0 && (s & 1) == 0 && s < nks) {
        wgmma_commit();
        wgmma_wait<0>();
        release(s);
        wgmma_fence();
      }
    } while (s < nks && !interval_starts(s));
    wgmma_commit();
  };
  issue(p0);
  int end0 = s, end1 = 0;
  for (;;) {
    bool more = s < nks;
    if (more) { issue(p1); end1 = s; wgmma_wait<1>(); } else { wgmma_wait<0>(); }
    reg_fence(p0);
    promote(acc, p0);
    release(end0);
    if (!more) break;
    more = s < nks;
    if (more) { issue(p0); end0 = s; wgmma_wait<1>(); } else { wgmma_wait<0>(); }
    reg_fence(p1);
    promote(acc, p1);
    release(end1);
    if (!more) break;
  }
}

// A barrier of consumer warpgroup g's 128 threads (named barriers 1, 2).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(g + 1) : "memory");
}

// The tile's body: the persistent walk of epi's items by one CTA of
// THREADS threads, each item over the tensor maps maps_of(item) (boxes of
// KB x ROWS). Epi provides nkb (k-blocks), items(), item(i), and the
// consumers' hooks begin(item, ctx), chunk(acc, item, col0, ctx) and
// end(item, ctx). side(w) runs on warps w = 1..3 of the producer
// warpgroup, which issue no TMA: 40 registers a thread, and no barrier
// the other warpgroups take part in.
template <class MapsOf, class Side, class Epi>
__device__ void run_tile_of(const MapsOf& maps_of, const Side& side, const Epi& epi,
                            unsigned char* smem_raw) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + (uint32_t)Layout::align - 1) & ~((uint32_t)Layout::align - 1);
  unsigned char* base = smem_raw + (ring - raw);
  const uint32_t full = ring + (uint32_t)Layout::bars, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
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
        const TileMaps m = maps_of(t);
        for (int col0 = t.c_begin; col0 < t.c_end; col0 += COLS)
          for (int kb = 0; kb < epi.nkb; ++kb, ++it) {
            const uint32_t st = it % STAGES;
            mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
            const uint32_t bar = full + 8 * st, dst = ring + st * STAGE_BYTES;
            mbar_expect_tx(bar, STAGE_BYTES);
            tma_load(dst, m.qh, bar, kb * KB, t.q0);
            tma_load(dst + TILE_BYTES, m.ql, bar, kb * KB, t.q0);
            tma_load(dst + 2 * TILE_BYTES, m.ch, bar, kb * KB, col0);
            tma_load(dst + 3 * TILE_BYTES, m.cl, bar, kb * KB, col0);
          }
      }
    } else if (threadIdx.x >= 32) {
      side(threadIdx.x / 32);
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int ctid = threadIdx.x - 128;
    Ctx ctx;
    ctx.Ds = reinterpret_cast<float*>(base + Layout::ds);
    ctx.nanf = reinterpret_cast<int*>(base + Layout::nanf);
    ctx.Lsd = reinterpret_cast<float*>(base + Layout::lists);
    ctx.Lsi = reinterpret_cast<int*>(ctx.Lsd + (epi.k <= KS ? ROWS * epi.k : 0));
    ctx.g = ctid / 128;
    ctx.cwarp = ctid / 32;
    ctx.lane = ctid % 32;
    float acc[64], p0[64], p1[64];
    uint32_t it = 0;
    for (int n = blockIdx.x; n < items; n += gridDim.x) {
      const Item t = epi.item(n);
      epi.begin(t, ctx);
      for (int col0 = t.c_begin; col0 < t.c_end; col0 += COLS) {
        chunk_product(acc, p0, p1, ring, full, empty, it, epi.nkb, ctx.g);
        it += epi.nkb;
        epi.chunk(acc, t, col0, ctx);
      }
      epi.end(t, ctx);
    }
  }
}

// run_tile_of with one set of tensor maps for every item and nothing on the
// producer's spare warps.
template <class Epi>
__device__ void run_tile(const CUtensorMap* qh, const CUtensorMap* ql, const CUtensorMap* ch,
                         const CUtensorMap* cl, const Epi& epi, unsigned char* smem_raw) {
  run_tile_of([=](const Item&) { return TileMaps{qh, ql, ch, cl}; }, [](int) {}, epi,
              smem_raw);
}

// The items of a sweep over query groups: group n's rows against columns
// [0, c_end), output rows from q0.
struct SweepItems {
  int Q, c_end;
  __device__ int items() const { return (Q + ROWS - 1) / ROWS; }
  __device__ Item item(int n) const { return Item{n * ROWS, 0, c_end, (size_t)n * ROWS}; }
};

// The items of (query group, column tile) pairs in bands of BAND query
// groups: a band's groups take each column tile in turn, so the CTAs in
// flight share column tiles and query groups in L2. Output rows of tile t
// start at t * Q.
struct TileItems {
  static constexpr int BAND = 8;
  int Q, C, c_span, c_limit;
  __device__ int groups() const { return (Q + ROWS - 1) / ROWS; }
  __device__ int items() const { return groups() * (C / c_span); }
  __device__ Item item(int n) const {
    const int ng = groups(), nt = C / c_span;
    const int band = n / (BAND * nt), j = n - band * BAND * nt;
    const int g0 = band * BAND, gs = min(BAND, ng - g0);
    const int tile = j / gs, qg = g0 + j % gs;
    const int c0 = tile * c_span;
    return Item{qg * ROWS, c0, min(min(c0 + c_span, C), c_limit),
                (size_t)tile * Q + (size_t)qg * ROWS};
  }
};

// ------------------------------------------------------------ the prologue

// x (f32 bits) -> the planes' hi and lo: hi = tf32_rna(x) by cvt (a NaN
// stays NaN), lo = tf32_rna(x - hi) where x - hi is finite, else x - hi.
__device__ __forceinline__ void split_plane(float x, float& hi, float& lo) {
  unsigned h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  hi = __uint_as_float(h & 0xffffe000u);
  const float d = __fsub_rn(x, hi);
  lo = isfinite(d) ? __uint_as_float(tf32_rna(__float_as_uint(d))) : d;
}

// The prologue of K1/K2's exact form: rows [0, N) of src -> the planes hi,
// lo (N, Dp) f32, zero past D, and norms (N,): the diagonal of each 128-row
// group's product with itself, by the tile's wgmma shape (each warpgroup's
// 64 rows against the group's 128), pass order and promotion intervals,
// on boxes of the same swizzled layout, built here in shared memory. One
// CTA of STAGE_THREADS per group, k-block by k-block.
template <class Src>
__global__ void __launch_bounds__(STAGE_THREADS, 1)
stage_split_kernel(Src src, int N, int D, int Dp, float* __restrict__ hi,
                   float* __restrict__ lo, float* __restrict__ norms) {
  __shared__ __align__(1024) unsigned char boxes[2][TILE_BYTES];
  const int tid = threadIdx.x, g = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int r0 = blockIdx.x * ROWS;
  const uint32_t bh = smem_addr(boxes[0]), bl = smem_addr(boxes[1]);
  const int nks = Dp / 8;
  float acc[64], P[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < Dp / KB; ++kb) {
    for (int e = tid; e < ROWS * KB; e += STAGE_THREADS) {
      const int r = e / KB, kk = e % KB, row = r0 + r, dim = kb * KB + kk;
      float h, l;
      split_plane(row < N && dim < D ? src.load(row, dim) : 0.f, h, l);
      if (row < N) {
        hi[(size_t)row * Dp + dim] = h;
        lo[(size_t)row * Dp + dim] = l;
      }
      const uint32_t off = swz64(r, kk);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(bh + off), "r"(__float_as_uint(h)));
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(bl + off), "r"(__float_as_uint(l)));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      const int s = 2 * kb + half;
      wgmma_fence();
      kstep3(P, bh, bl, bh, bl, g, half, interval_starts(s));
      wgmma_commit();
      if (interval_ends(s, nks)) {
        wgmma_wait<0>();
        reg_fence(P);
        promote(acc, P);
      }
    }
    wgmma_wait<0>();  // the boxes are read before they are overwritten
    __syncthreads();
  }
  // row R = 64 g + 16 w + lane/4 (+ 8) meets column R at element 4 (R / 8)
  // + 2 (+ 0 or 2) + R % 8 - 2 (lane % 4), when that is 0 or 1
  const int e = lane / 4 - 2 * (lane % 4);
  if (e == 0 || e == 1) {
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j == 8 * g + 2 * w) v0 = e ? acc[4 * j + 1] : acc[4 * j];
      if (j == 8 * g + 2 * w + 1) v1 = e ? acc[4 * j + 3] : acc[4 * j + 2];
    }
    const int ra = r0 + 64 * g + 16 * w + lane / 4;
    if (ra < N) norms[ra] = v0;
    if (ra + 8 < N) norms[ra + 8] = v1;
  }
}

// The planes' pitch: D rounded up to the k-block.
__host__ __device__ inline int split_width(int D) { return (D + KB - 1) / KB * KB; }

template <class Src>
cudaError_t stage_split(const Src& src, int N, int D, int Dp, float* hi, float* lo,
                        float* norms, cudaStream_t stream) {
  if (N <= 0 || D <= 0 || Dp != split_width(D)) return cudaErrorInvalidValue;
  stage_split_kernel<<<(N + ROWS - 1) / ROWS, STAGE_THREADS, 0, stream>>>(src, N, D, Dp, hi,
                                                                         lo, norms);
  return cudaGetLastError();
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// driver entry point (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of a plane (rows, Dp) f32: boxes of KB x ROWS, 64-byte
// swizzle, rows past the plane read as zeros.
inline cudaError_t plane_map(CUtensorMap* map, const float* plane, int rows, int Dp) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(plane) & 15) || Dp % KB || rows <= 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)Dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Dp * sizeof(float)};
  const cuuint32_t box[2] = {KB, ROWS}, step[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(plane), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The persistent grid of a tile kernel: min(items, SMs x CTAs per SM).
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

}  // namespace wg
}  // namespace knn

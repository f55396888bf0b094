// The mma.sync tile of the compress kernels K1[c] (fused_knn.cu) and K3b
// (fused_ring.cu), of the ring's exact block merge (fused_ring.cu) and of
// the ring transport kernels (fused_ring_dma.cu: K5, and K4's bf16 and
// int8 wires), for Hopper (sm_90a): one tensor-core tile, `sweep_mma`,
// parametrised by its operand policy. Its selection (`select_chunk`) also
// serves knn_wgmma.cuh, the exact tile of K1, K2 and K4's f32 wire.
//
// One CTA owns ROWS query rows (MQB = 128, or NQB = 64 where 128-row groups
// would leave the card's resident slots empty) and sweeps a range of columns
// in chunks of MCB = 128. 8 warps each hold a (ROWS/2) x 32 block of f32
// accumulators and run mma.sync on the tensor cores, fed by ldmatrix from a
// 3-stage ring of 64-byte row slices (rows at an 80-byte pitch, so ldmatrix
// meets no bank conflict). After the K loop the masked keys
// q^2 - 2 q.c + c^2 go to a shared key tile (Ds aliases the drained ring) and
// only the survivors of the selection reach device memory.
//
// The operand policies:
//
//   Bf16x1, the compress tile (the mixed policy's pass 1). Its operands are
//   bf16 copies that the staging prologue (`stage_bf16_kernel`) made once
//   per row set: rounded to nearest even, zero-padded to a multiple of MKD,
//   with the f32 squared norm of the unrounded row. One m16n8k16 pass per
//   16-deep k-step; a bf16 x bf16 product is exact in f32, so the keys are
//   the bf16 dot with the tensor cores' own f32 sums.
//
//   Bf16x1F32 and Bf16x3, the f32 tile at matmul_precision "default" and
//   "high" (K1, K2, K3a, K4, K5). Their operands are the exact tile's f32
//   slices; after the fragment load each value is rounded to bf16 (nearest
//   even: one pass) or split into bf16 hi + lo (three passes, lo.hi,
//   hi.lo, hi.hi), one 16-deep m16n8k16 k-step per slice, promoted as
//   Tf32x3's. The norms stay the f32 ones of the exact prologue.
//
//   Tf32x3, the exact tile. Its operands are the f32 rows themselves, 16
//   floats per slice (the same 64 bytes as a bf16 slice of 32). After the
//   fragment load each value x is split in registers, hi = tf32_rna(x),
//   lo = tf32_rna(x - hi), and each 8-deep k-step runs three m16n8k8 TF32
//   products in a fixed order, lo.hi, hi.lo, hi.hi, into the f32 sums:
//   x.y = hi.hi + hi.lo + lo.hi up to the dropped lo.lo (~2^-22 relative).
//   Each k-step's three products go into a zeroed partial that is added to
//   the sum with one FADD (round to nearest), as FP8 GEMMs promote their
//   partials. Values that fit in 11 significant bits (small
//   integers) split with lo = 0, and then the sums are exact. The norms
//   come from the prologue `stage_tf32_kernel`, once per row set: the
//   diagonal of each 16-row group's product with itself, by the same
//   k-step, pass and accumulation sequence, so an exact duplicate pair
//   gives q^2 - 2 q.c + c^2 == 0 bit for bit (this rests on the tensor
//   cores giving an element the same bits at any fragment position, which
//   the card tests check).
//
// Staging. bf16 copies and f32 rows whose stride and base are 16-byte
// aligned go global -> shared by cp.async.cg (which bypasses L1); other
// operands (the bf16 and int8 ring wires, widths not a multiple of 4) are
// decoded in registers by the column policy's load() and stored to shared
// memory. Rows past the range and widths past D are zero-filled.
//
// What bounds it. The exact tile's products: 3 x 2 Q C D FLOP at the dense
// TF32 peak (494.7 TFLOP/s on an H100 SXM); the compress tile's at the bf16
// peak, where the selection weighs more than the product. The selection: a
// row whose keys all lose to its list's worst costs one compare per key
// (k <= 64); a row with winners takes its list into the warp's registers
// (RegList) and inserts with shuffles; k > 64 inserts into shared-memory
// lists with warp_offer, and lists longer than KMAX_SMEM live in a global
// buffer the caller names.
//
// Every column is offered to its row's ascending list of the k best
// candidates, ordered lexicographically by (distance, key); keys are
// unique, so the lists do not depend on the order of the offers. What a
// column's value, norm, mask and key are is the caller's policy (`Src`):
//
//   float load(int col, int dim)   the column element after its wire decode
//                                  (the register staging path and the
//                                  prologues)
//   float norm(int col)            the column's squared norm (from a prologue)
//   bool masked(int row, int col, float d, float qs, float cs)
//   int key(int col)               the tie order and what the list stores
//   static constexpr bool clamp     max(d, 0), keeping NaN
//   static constexpr bool nan_as_inf  a NaN key is +inf (else it poisons
//                                     the row)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int THREADS = 256;       // 8 warps: 2 x 4 warp tiles
constexpr int KMAX_SMEM = 128;     // longest list kept in shared memory
constexpr unsigned FULL = 0xffffffffu;

constexpr int MQB = 128;           // query rows per CTA (wide tile)
constexpr int NQB = 64;            // query rows per CTA (narrow tile)
constexpr int MCB = 128;           // columns per chunk
constexpr int MKD = 32;            // bf16 elements per staged slice
constexpr int TKD = 16;            // f32 elements per staged slice
constexpr int SLICE_BYTES = 64;    // one row's slice, either policy
constexpr int PITCH = 80;          // smem row pitch in bytes: ldmatrix conflict-free
constexpr int MSTAGES = 3;         // staging ring
constexpr int MDS = MCB + 1;       // key tile row pitch (floats)
constexpr int STAGE_ROWS = 32;     // rows per CTA of the bf16 prologue
static_assert(MKD * 2 == SLICE_BYTES && TKD * 4 == SLICE_BYTES, "one slice geometry");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

__device__ __forceinline__ bool lex_less(float d, int i, float wd, int wi) {
  // NaN compares false both ways, so a NaN never enters a list
  return d < wd || (d == wd && i < wi);
}

// Insert (cd, cid) into the ascending list L[0..k) of one row; the whole
// warp takes part. The caller guarantees (cd, cid) < L[k-1].
__device__ inline void warp_insert(float* Ld, int* Li, int k, float cd,
                                   int cid, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    int j = base + lane;
    bool lt = j < k && lex_less(Ld[j], Li[j], cd, cid);
    pos += __popc(__ballot_sync(FULL, lt));
  }
  // shift [pos, k-1) up by one, highest segment first
  for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
    int j = base + lane;
    bool mv = j >= pos && j + 1 < k;
    float v = 0.f;
    int vi = 0;
    if (mv) { v = Ld[j]; vi = Li[j]; }
    __syncwarp();
    if (mv) { Ld[j + 1] = v; Li[j + 1] = vi; }
    __syncwarp();
  }
  if (lane == 0) { Ld[pos] = cd; Li[pos] = cid; }
  __syncwarp();
}

// Every lane of the warp offers one candidate (when `active`); each one that
// beats the list's current worst is inserted. Keys are unique, so the list
// ends up holding the k smallest offered candidates whatever the order of
// insertion. Returns whether an active lane offered a NaN distance.
__device__ inline bool warp_offer(float* Ld, int* Li, int k, float d, int key,
                                  bool active, int lane) {
  bool any_nan = __any_sync(FULL, active && d != d);
  bool pass = active && lex_less(d, key, Ld[k - 1], Li[k - 1]);
  unsigned m = __ballot_sync(FULL, pass);
  while (m) {
    int src = __ffs(m) - 1;
    float cd = __shfl_sync(FULL, d, src);
    int cid = __shfl_sync(FULL, key, src);
    warp_insert(Ld, Li, k, cd, cid, lane);
    if (lane == src) pass = false;
    pass = pass && lex_less(d, key, Ld[k - 1], Li[k - 1]);
    m = __ballot_sync(FULL, pass);
  }
  return any_nan;
}

// One row's list of k <= 32 * NR entries held across the warp's registers
// while a chunk is offered: lane l holds entries l + 32 s (s < NR); entries
// past k are ignored. The same (distance, key) insertion as warp_insert,
// with shuffles in place of shared-memory shifts and warp barriers.
template <int NR>
struct RegList {
  float d[NR];
  int i[NR];

  __device__ void load(const float* Ld, const int* Li, int k, int lane) {
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      int j = lane + 32 * s;
      d[s] = j < k ? Ld[j] : inf_f();
      i[s] = j < k ? Li[j] : 0;
    }
  }
  __device__ void store(float* Ld, int* Li, int k, int lane) const {
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      int j = lane + 32 * s;
      if (j < k) { Ld[j] = d[s]; Li[j] = i[s]; }
    }
  }
  // entry k - 1, the worst, on every lane
  __device__ void worst(int k, float& wd, int& wi) const {
    float vd = d[0];
    int vi = i[0];
#pragma unroll
    for (int s = 1; s < NR; ++s)
      if (s == (k - 1) / 32) { vd = d[s]; vi = i[s]; }
    wd = __shfl_sync(FULL, vd, (k - 1) % 32);
    wi = __shfl_sync(FULL, vi, (k - 1) % 32);
  }
  // insert (cd, cid), which beats entry k - 1; the whole warp takes part
  __device__ void insert(int k, float cd, int cid, int lane) {
    int pos = 0;
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      bool lt = lane + 32 * s < k && lex_less(d[s], i[s], cd, cid);
      pos += __popc(__ballot_sync(FULL, lt));
    }
    float nd[NR];
    int ni[NR];
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      float up = __shfl_up_sync(FULL, d[s], 1);
      int upi = __shfl_up_sync(FULL, i[s], 1);
      if (s > 0) {  // entry 32 s - 1 moves to lane 0 of slot s
        float last = __shfl_sync(FULL, d[s - 1], 31);
        int lasti = __shfl_sync(FULL, i[s - 1], 31);
        if (lane == 0) { up = last; upi = lasti; }
      }
      int j = lane + 32 * s;
      nd[s] = j > pos ? up : (j == pos ? cd : d[s]);
      ni[s] = j > pos ? upi : (j == pos ? cid : i[s]);
    }
#pragma unroll
    for (int s = 0; s < NR; ++s) { d[s] = nd[s]; i[s] = ni[s]; }
  }
};

// ------------------------------------------------------------ shared memory

// Shared memory of one CTA of ROWS query rows: the staging ring (As, Bs)
// and the key tile Ds share one region, used in turn.
template <int ROWS>
struct MmaSmem {
  unsigned char* As;  // [MSTAGES][ROWS][PITCH]
  unsigned char* Bs;  // [MSTAGES][MCB][PITCH]
  float* Ds;          // [ROWS][MDS]
  float* qn;          // [ROWS]
  float* cn;          // [MCB]
  int* nanf;          // [ROWS] row saw a NaN
  float* Lsd;         // [ROWS][k] (k <= KMAX_SMEM)
  int* Lsi;
};

// The bytes of the region the ring and the key tile share.
template <int ROWS>
struct Region {
  static constexpr size_t ring = (size_t)MSTAGES * (ROWS + MCB) * PITCH;
  static constexpr size_t ds = sizeof(float) * ROWS * MDS;
  static constexpr size_t bytes = ((ring > ds ? ring : ds) + 15) / 16 * 16;
};

template <int ROWS = MQB>
__device__ inline MmaSmem<ROWS> carve_mma(unsigned char* smem, int k) {
  MmaSmem<ROWS> s;
  s.As = smem;
  s.Bs = smem + (size_t)MSTAGES * ROWS * PITCH;
  s.Ds = reinterpret_cast<float*>(smem);
  s.qn = reinterpret_cast<float*>(smem + Region<ROWS>::bytes);
  s.cn = s.qn + ROWS;
  s.nanf = reinterpret_cast<int*>(s.cn + MCB);
  s.Lsd = reinterpret_cast<float*>(s.nanf + ROWS);
  s.Lsi = reinterpret_cast<int*>(s.Lsd + ROWS * k);
  return s;
}

template <int ROWS = MQB>
inline size_t mma_smem_bytes(int k) {
  size_t b = Region<ROWS>::bytes + sizeof(float) * (ROWS + MCB) + sizeof(int) * ROWS;
  if (k <= KMAX_SMEM) b += (sizeof(float) + sizeof(int)) * (size_t)ROWS * k;
  return b;
}

template <int ROWS = MQB>
inline cudaError_t set_mma_smem(const void* kernel, int k) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)mma_smem_bytes<ROWS>(k));
}

// Registers and local (spilled) bytes a thread, and CTAs per SM, of a tile
// kernel of ROWS query rows at list width k.
template <int ROWS = MQB>
inline cudaError_t mma_kernel_info(const void* kernel, int k, int* regs,
                                   int* local_bytes, int* ctas_per_sm) {
  cudaError_t err = set_mma_smem<ROWS>(kernel, k);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, THREADS,
                                                        mma_smem_bytes<ROWS>(k));
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// The CTA's query rows of a launch: MQB, unless `groups_at_mqb` CTAs of MQB
// rows would not fill the card's resident slots of the MQB kernel, then NQB
// (twice the CTAs, each on half the rows).
inline cudaError_t pick_rows(const void* kernel_mqb, int k, long long groups_at_mqb,
                             int* rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = set_mma_smem<MQB>(kernel_mqb, k);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_mqb, THREADS,
                                                      mma_smem_bytes<MQB>(k));
  if (e != cudaSuccess) return e;
  *rows = groups_at_mqb < (long long)per_sm * sms ? NQB : MQB;
  return cudaSuccess;
}

// The CTA's lists: shared memory for small k, else row (row0 + r) of a
// (rows, k) global buffer.
template <int ROWS = MQB>
struct MmaLists {
  MmaSmem<ROWS> sm;
  float* gd;
  int* gi;
  size_t row0;
  int k;
  __device__ float* d(int r) const {
    return k <= KMAX_SMEM ? sm.Lsd + r * k : gd + (row0 + r) * (size_t)k;
  }
  __device__ int* i(int r) const {
    return k <= KMAX_SMEM ? sm.Lsi + r * k : gi + (row0 + r) * (size_t)k;
  }
};

// The lists of rows warp, warp + nwarps, ... of [q0, q0+ROWS) filled with
// (+inf, sentinel) and their NaN flags cleared. A sentinel of -1 keeps
// +inf candidates out of the lists; a sentinel of INT_MAX lets them in, in
// key order.
template <int ROWS, class LT>
__device__ inline void init_rows(const LT& L, int* nanf, int q0, int Q, int sentinel,
                                 int warp, int nwarps) {
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += nwarps) {
    if (q0 + r >= Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    for (int j = lane; j < L.k; j += 32) { Ld[j] = inf_f(); Li[j] = sentinel; }
    if (lane == 0) nanf[r] = 0;
  }
}

// Every list of the CTA initialised (init_rows); ROWS is the CTA's query
// rows.
template <int ROWS, class LT>
__device__ inline void init_lists(const LT& L, int q0, int Q, int sentinel) {
  init_rows<ROWS>(L, L.sm.nanf, q0, Q, sentinel, threadIdx.x / 32, THREADS / 32);
  __syncthreads();
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (dst a shared-window address), zero-filled when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void st_shared_v4(unsigned dst, float a, float b, float c,
                                             float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "f"(a), "f"(b),
               "f"(c), "f"(d));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on the tensor cores: a 16x8 tf32 (row), b 8x8 tf32 (col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x (f32 bits) = hi + lo: hi = tf32_rna(x), lo = tf32_rna(x - hi) (x - hi
// is exact in f32), where tf32_rna rounds to 10 stored mantissa bits, ties
// away from zero, and clears the 13 low bits: add half a tf32 ulp to the
// magnitude bits, clear the low bits (two integer operations). That is
// cvt.rna.tf32.f32 on every finite value; a NaN may come out as a number.
// So the tile splits with it (split_tf32), while the prologue's split
// (split_tf32_norm, which takes hi by cvt) keeps a non-finite value
// non-finite and makes its row's norm NaN: every key of that row or column
// is then NaN, whatever the tile's products are.
__device__ __forceinline__ unsigned tf32_rna(unsigned x) {
  return (x + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi))));
}

__device__ __forceinline__ void split_tf32_norm(unsigned x, unsigned& hi,
                                                unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(x)));
  hi &= 0xffffe000u;
  lo = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi))));
}

// ------------------------------------------------------------ operand policies

// The compress tile: one bf16 pass per 16-deep k-step.
struct Bf16x1 {
  static constexpr bool promote = false;
  static constexpr bool k16 = false;
  struct AFrag { unsigned r[4]; };
  struct BFrag { unsigned r[2]; };
  __device__ static AFrag a_frag(const unsigned (&x)[4]) {
    return AFrag{{x[0], x[1], x[2], x[3]}};
  }
  __device__ static BFrag b_frag(unsigned x0, unsigned x1) { return BFrag{{x0, x1}}; }
  __device__ static void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    mma_bf16(c, a.r, b.r[0], b.r[1]);
  }
};

// The exact tile: f32 split into tf32 hi + lo, three passes per 8-deep
// k-step in the order lo.hi, hi.lo, hi.hi.
struct Tf32x3 {
  static constexpr bool promote = true;
  static constexpr bool k16 = false;
  struct AFrag { unsigned hi[4], lo[4]; };
  struct BFrag { unsigned hi[2], lo[2]; };
  __device__ static AFrag a_frag(const unsigned (&x)[4]) {
    AFrag f;
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(x[j], f.hi[j], f.lo[j]);
    return f;
  }
  __device__ static BFrag b_frag(unsigned x0, unsigned x1) {
    BFrag f;
    split_tf32(x0, f.hi[0], f.lo[0]);
    split_tf32(x1, f.hi[1], f.lo[1]);
    return f;
  }
  __device__ static void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// Two f32 values as a bf16 pair, each rounded to nearest even (a in the
// low half: the lower k of the pair).
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

// x = hi + lo with hi = bf16_rn(x) and lo = bf16_rn(x - hi) (x - hi is
// exact in f32), as bf16 pairs of the f32 values a and b.
__device__ __forceinline__ void split_bf16(unsigned a, unsigned b, unsigned& hi,
                                           unsigned& lo) {
  const float fa = __uint_as_float(a), fb = __uint_as_float(b);
  const float ha = __bfloat162float(__float2bfloat16_rn(fa));
  const float hb = __bfloat162float(__float2bfloat16_rn(fb));
  hi = pack_bf16(ha, hb);
  lo = pack_bf16(__fsub_rn(fa, ha), __fsub_rn(fb, hb));
}

// The f32-operand bf16 policies (matmul_precision "default" and "high")
// read the exact tile's f32 slices and run one 16-deep bf16 k-step per
// slice. The ldmatrix fragments of the slice's two 8-deep halves (x, y)
// give lane (g, t) the values at k = t, t + 4 (x) and t + 8, t + 12 (y) of
// its rows g, g + 8 (A) and of its column g (B); the bf16 fragment holds
// k = 2t, 2t + 1, 2t + 8, 2t + 9. A dot product does not depend on the
// order of its terms, so A and B both put k = t, t + 4, t + 8, t + 12 in
// the bf16 slots 2t, 2t + 1, 2t + 8, 2t + 9.

// "default": each f32 operand rounded to bf16 (nearest even), one pass:
// the TPU's DEFAULT on f32 operands. Each 16-deep k-step's product goes
// into a zeroed partial added to the sum with one FADD, as Tf32x3's.
struct Bf16x1F32 {
  static constexpr bool promote = true;
  static constexpr bool k16 = true;
  struct AFrag { unsigned r[4]; };
  struct BFrag { unsigned r[2]; };
  __device__ static unsigned pack(unsigned a, unsigned b) {
    return pack_bf16(__uint_as_float(a), __uint_as_float(b));
  }
  __device__ static AFrag a_frag(const unsigned (&x)[4], const unsigned (&y)[4]) {
    return AFrag{{pack(x[0], x[2]), pack(x[1], x[3]), pack(y[0], y[2]), pack(y[1], y[3])}};
  }
  __device__ static BFrag b_frag(unsigned x0, unsigned x1, unsigned y0, unsigned y1) {
    return BFrag{{pack(x0, x1), pack(y0, y1)}};
  }
  __device__ static void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    mma_bf16(c, a.r, b.r[0], b.r[1]);
  }
};

// "high": each f32 operand split into bf16 hi + lo, three passes per
// 16-deep k-step in Tf32x3's order, lo.hi, hi.lo, hi.hi, promoted as it
// is: x.y = hi.hi + hi.lo + lo.hi up to the dropped lo.lo and lo's
// rounding (~2^-16 relative).
struct Bf16x3 {
  static constexpr bool promote = true;
  static constexpr bool k16 = true;
  struct AFrag { unsigned hi[4], lo[4]; };
  struct BFrag { unsigned hi[2], lo[2]; };
  __device__ static AFrag a_frag(const unsigned (&x)[4], const unsigned (&y)[4]) {
    AFrag f;
    split_bf16(x[0], x[2], f.hi[0], f.lo[0]);
    split_bf16(x[1], x[3], f.hi[1], f.lo[1]);
    split_bf16(y[0], y[2], f.hi[2], f.lo[2]);
    split_bf16(y[1], y[3], f.hi[3], f.lo[3]);
    return f;
  }
  __device__ static BFrag b_frag(unsigned x0, unsigned x1, unsigned y0, unsigned y1) {
    BFrag f;
    split_bf16(x0, x1, f.hi[0], f.lo[0]);
    split_bf16(y0, y1, f.hi[1], f.lo[1]);
    return f;
  }
  __device__ static void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    mma_bf16(c, a.lo, b.hi[0], b.hi[1]);
    mma_bf16(c, a.hi, b.lo[0], b.lo[1]);
    mma_bf16(c, a.hi, b.hi[0], b.hi[1]);
  }
};

// The operand policy of an f32 tile by its matmul precision code (0
// "highest", 1 "default", 2 "high"): f(Op{}) for that policy.
template <class F>
auto with_precision(int precision, F f) {
  if (precision == 1) return f(Bf16x1F32{});
  if (precision == 2) return f(Bf16x3{});
  return f(Tf32x3{});
}

// One output block's k-step: acc (+)= a . b, or with promotion
// acc = acc + (0 + a . b) with one FADD per output.
template <class Op>
__device__ __forceinline__ void mma_step(float (&acc)[4], const typename Op::AFrag& a,
                                         const typename Op::BFrag& b) {
  if constexpr (Op::promote) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    Op::mma(part, a, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
  } else {
    Op::mma(acc, a, b);
  }
}

// bf16 rows (the prologue's copies), staged by cp.async: row g's slice kt
// is the 64 bytes at x + g * Dp + kt * MKD.
struct Bf16Operand {
  const bf16* x;
  int Dp;  // a multiple of MKD
  __device__ void stage(unsigned dst, int g, bool valid, int kt, int ch) const {
    const bf16* from = valid ? x + (size_t)g * Dp + kt * MKD + ch * 8 : x;
    cp_async16(dst, from, valid);
  }
};

// f32 rows of width D for the exact tile: staged by cp.async when `rows` is
// set (a 16-byte aligned base, D a multiple of 4), else decoded in
// registers through src.load. Dims past D are zeros.
template <class Src>
struct F32Operand {
  Src src;
  const float* rows;
  int D;
  __device__ void stage(unsigned dst, int g, bool valid, int kt, int ch) const {
    const int dim0 = kt * TKD + ch * 4;
    if (rows != nullptr) {
      const bool in = valid && dim0 < D;
      cp_async16(dst, in ? rows + (size_t)g * D + dim0 : rows, in);
      return;
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = valid && dim0 + j < D ? src.load(g, dim0 + j) : 0.f;
    st_shared_v4(dst, v[0], v[1], v[2], v[3]);
  }
};

// The f32 rows of `x` may go through cp.async: 16-byte aligned rows.
__device__ __forceinline__ const float* async_rows(const void* x, int D) {
  return D % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0
             ? static_cast<const float*>(x)
             : nullptr;
}

// A row set at f32 (queries, or a dense corpus).
struct F32Rows {
  const float* x;
  int D;
  __device__ float load(int row, int dim) const { return x[(size_t)row * D + dim]; }
};

// ------------------------------------------------------------ the tile

// The selection of one key chunk: the keys of query rows [q0, q0+ROWS)
// and columns [col0, col0+MCB) lie in Ds (pitch MDS, +inf where masked),
// and warp `warp` of `nwarps` offers rows warp, warp + nwarps, ... to their
// lists. For k <= 64 a row whose keys all lose to its list's worst entry
// costs one compare per key; otherwise its list is taken into registers and
// the winners inserted there (RegList), then written back; k > 64 inserts
// in place with warp_offer. A row that meets a NaN key sets nanf[r]. The
// caller synchronises around it (Ds written before, read before reuse). LT
// is a list set with d(r), i(r) and k; both tiles call this.
template <int ROWS, class Src, class LT>
__device__ void select_chunk(const Src& src, const float* Ds, int* nanf, const LT& L,
                             int q0, int Q, int col0, int c_end, int warp,
                             int nwarps) {
  const int lane = threadIdx.x % 32;
  const int k = L.k;
  constexpr int H = MCB / 32;
  for (int r = warp; r < ROWS; r += nwarps) {
    if (q0 + r >= Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    float cd[H];
    int ck[H];
    bool act[H];
    bool nan_here = false;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      int cc = lane + 32 * h;
      int col = col0 + cc;
      float d = Ds[r * MDS + cc];
      if (src.nan_as_inf && d != d) d = inf_f();
      cd[h] = d;
      ck[h] = src.key(col);
      act[h] = col < c_end;
      nan_here |= act[h] && d != d;
    }
    if (__any_sync(FULL, nan_here) && lane == 0) nanf[r] = 1;
    if (k <= 64) {
      float wd = Ld[k - 1];
      int wi = Li[k - 1];
      bool any = false;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        act[h] = act[h] && lex_less(cd[h], ck[h], wd, wi);
        any |= act[h];
      }
      if (!__any_sync(FULL, any)) continue;
      RegList<2> R;
      R.load(Ld, Li, k, lane);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        bool pass = act[h] && lex_less(cd[h], ck[h], wd, wi);
        unsigned m = __ballot_sync(FULL, pass);
        while (m) {
          int from = __ffs(m) - 1;
          R.insert(k, __shfl_sync(FULL, cd[h], from), __shfl_sync(FULL, ck[h], from),
                   lane);
          if (lane == from) pass = false;
          R.worst(k, wd, wi);
          pass = pass && lex_less(cd[h], ck[h], wd, wi);
          m = __ballot_sync(FULL, pass);
        }
      }
      __syncwarp();  // every lane has read the list before it changes
      R.store(Ld, Li, k, lane);
      __syncwarp();
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) warp_offer(Ld, Li, k, cd[h], ck[h], act[h], lane);
      __syncwarp();
    }
  }
}


// The products of query rows [q0, q0+ROWS) and columns [col0, col0+MCB)
// into each warp's accumulators, over nk slices, through the staging
// ring. Rows past Q and columns past c_end are zero-filled. Ends with the
// ring drained and every thread's reads of it done.
template <class Op, int ROWS, class QOp, class COp>
__device__ void tile_product(const QOp& qa, const COp& ca, int nk, int Q, int q0,
                             int c_end, int col0, const MmaSmem<ROWS>& sm,
                             float (&acc)[ROWS / 32][4][4]) {
  constexpr int MI = ROWS / 32;
  constexpr unsigned A_STAGE = ROWS * PITCH, B_STAGE = MCB * PITCH;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile rows wm*16*MI, cols wn*32
  // shared-window addresses: the rings, and this lane's ldmatrix rows in
  // slot 0 (A: rows wm*16*MI + lane%16, B: columns wn*32 + 8*(lane/16) +
  // lane%8, each at its 16-byte half of the k-step)
  const unsigned as0 = smem_addr(sm.As), bs0 = smem_addr(sm.Bs);
  const unsigned a_lane = as0 + (wm * 16 * MI + lane % 16) * PITCH + (lane / 16) * 16;
  const unsigned b_lane =
      bs0 + (wn * 32 + (lane / 16) * 8 + lane % 8) * PITCH + ((lane / 8) % 2) * 16;

  // slice kt of the query and column rows into ring slot kt % MSTAGES
  auto stage = [&](int kt) {
    const unsigned slot = kt % MSTAGES;
    constexpr int CHUNKS = SLICE_BYTES / 16;
#pragma unroll
    for (int i = 0; i < (ROWS + MCB) * CHUNKS / THREADS; ++i) {
      int e = tid + i * THREADS;
      int r = e / CHUNKS, ch = e % CHUNKS;
      if (r < ROWS) {
        qa.stage(as0 + slot * A_STAGE + r * PITCH + ch * 16, q0 + r, q0 + r < Q, kt, ch);
      } else {
        int rr = r - ROWS;
        ca.stage(bs0 + slot * B_STAGE + rr * PITCH + ch * 16, col0 + rr,
                 col0 + rr < c_end, kt, ch);
      }
    }
  };

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  // one commit group per slice (empty past nk), so wait_group counts hold
#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MSTAGES - 2>();  // slice kt has landed (this thread's part)
    __syncthreads();               // ... every thread's; slot kt-1 is free
    if (kt + MSTAGES - 1 < nk) stage(kt + MSTAGES - 1);
    cp_async_commit();
    const unsigned slot = kt % MSTAGES;
    const unsigned as = a_lane + slot * A_STAGE, bs = b_lane + slot * B_STAGE;
    if constexpr (Op::k16) {  // f32 slices, one 16-deep bf16 k-step each
      typename Op::BFrag b[4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned x[4], y[4];
        ldmatrix_x4(x, bs + nj * 16 * PITCH);
        ldmatrix_x4(y, bs + nj * 16 * PITCH + 32);
        b[2 * nj] = Op::b_frag(x[0], x[1], y[0], y[1]);
        b[2 * nj + 1] = Op::b_frag(x[2], x[3], y[2], y[3]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        unsigned x[4], y[4];
        ldmatrix_x4(x, as + mi * 16 * PITCH);
        ldmatrix_x4(y, as + mi * 16 * PITCH + 32);
        const typename Op::AFrag a = Op::a_frag(x, y);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_step<Op>(acc[mi][ni], a, b[ni]);
      }
    } else {
#pragma unroll
    for (int kb = 0; kb < SLICE_BYTES; kb += 32) {  // two k-steps per slice
      typename Op::BFrag b[4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        ldmatrix_x4(r, bs + nj * 16 * PITCH + kb);
        b[2 * nj] = Op::b_frag(r[0], r[1]);
        b[2 * nj + 1] = Op::b_frag(r[2], r[3]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        unsigned r[4];
        ldmatrix_x4(r, as + mi * 16 * PITCH + kb);
        const typename Op::AFrag a = Op::a_frag(r);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_step<Op>(acc[mi][ni], a, b[ni]);
      }
    }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained and read: Ds may overwrite it
}

// The CTA's query rows [q0, q0+ROWS) against columns [c_begin, c_end),
// offered to the lists. qa / ca are the query and column operands (nk
// slices deep), qn the query norms; the column norms come from src.norm.
template <class Op, int ROWS, class Src, class QOp, class COp>
__device__ void sweep_mma(const Src& src, const QOp& qa, const float* __restrict__ qn,
                          int Q, const COp& ca, int nk, int q0, int c_begin,
                          int c_end, const MmaLists<ROWS>& L) {
  constexpr int MI = ROWS / 32;
  const MmaSmem<ROWS>& sm = L.sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  for (int r = tid; r < ROWS; r += THREADS) sm.qn[r] = q0 + r < Q ? qn[q0 + r] : 0.f;

  for (int col0 = c_begin; col0 < c_end; col0 += MCB) {
    for (int c = tid; c < MCB; c += THREADS)
      sm.cn[c] = col0 + c < c_end ? src.norm(col0 + c) : 0.f;

    float acc[MI][4][4];
    tile_product<Op, ROWS>(qa, ca, nk, Q, q0, c_end, col0, sm, acc);

    // masked keys -> Ds. Accumulator j of (mi, ni) sits at row
    // lane/4 + 8*(j/2), column 2*(lane%4) + j%2 of that 16 x 8 block.
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int r = wm * 16 * MI + mi * 16 + lane / 4 + 8 * (j / 2);
          int cc = wn * 32 + ni * 8 + 2 * (lane % 4) + j % 2;
          int row = q0 + r, col = col0 + cc;
          float qs = sm.qn[r], cs = sm.cn[cc];
          float d = __fadd_rn(__fsub_rn(qs, __fmul_rn(2.f, acc[mi][ni][j])), cs);
          if (src.clamp) d = d < 0.f ? 0.f : d;  // max(d, 0) that keeps NaN
          bool invalid = col >= c_end || row >= Q || src.masked(row, col, d, qs, cs);
          sm.Ds[r * MDS + cc] = invalid ? inf_f() : d;
        }
    __syncthreads();

    select_chunk<ROWS>(src, sm.Ds, sm.nanf, L, q0, Q, col0, c_end, warp,
                       THREADS / 32);
    __syncthreads();  // Ds is read before the next chunk's ring overwrites it
  }
  __syncthreads();
}

// The f32 tile's raw products (policy Op) of query rows [q0, q0+ROWS) and
// columns [col0, col0+MCB): out (Q, C) f32. A test hook: the card tests
// hold the prologue's norms against the Tf32x3 diagonal.
template <class Op, int ROWS, class QOp, class COp>
__device__ void tile_dots(const QOp& qa, const COp& ca, int nk, int Q, int C, int q0,
                          int col0, unsigned char* smem, float* __restrict__ out) {
  constexpr int MI = ROWS / 32;
  const MmaSmem<ROWS> sm = carve_mma<ROWS>(smem, 0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[MI][4][4];
  tile_product<Op, ROWS>(qa, ca, nk, Q, q0, C, col0, sm, acc);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int row = q0 + wm * 16 * MI + mi * 16 + lane / 4 + 8 * (j / 2);
        int col = col0 + wn * 32 + ni * 8 + 2 * (lane % 4) + j % 2;
        if (row < Q && col < C) out[(size_t)row * C + col] = acc[mi][ni][j];
      }
}

// ------------------------------------------------------------ prologues

// The bf16 prologue: rows [0, N) of `src` -> out (N, Dp) bf16, rounded to
// nearest even and zero-padded past D, and norms (N,) f32, the squared norm
// of the unrounded row summed with one fmaf accumulator over the dims in
// ascending order. One CTA per STAGE_ROWS rows.
template <class Src>
__global__ void __launch_bounds__(THREADS)
stage_bf16_kernel(Src src, int N, int D, int Dp, bf16* __restrict__ out,
                  float* __restrict__ norms) {
  __shared__ float tile[STAGE_ROWS][MKD + 1];
  const int r0 = blockIdx.x * STAGE_ROWS, tid = threadIdx.x;
  float acc = 0.f;
  for (int d0 = 0; d0 < Dp; d0 += MKD) {
    for (int e = tid; e < STAGE_ROWS * MKD; e += THREADS) {
      int r = e / MKD, dd = e % MKD;
      int row = r0 + r, dim = d0 + dd;
      float v = (row < N && dim < D) ? src.load(row, dim) : 0.f;
      tile[r][dd] = v;
      if (row < N) out[(size_t)row * Dp + dim] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    if (tid < STAGE_ROWS)
      for (int dd = 0; dd < MKD; ++dd) acc = fmaf(tile[tid][dd], tile[tid][dd], acc);
    __syncthreads();
  }
  if (tid < STAGE_ROWS && r0 + tid < N) norms[r0 + tid] = acc;
}

template <class Src>
cudaError_t stage_bf16(const Src& src, int N, int D, int Dp, bf16* out,
                       float* norms, cudaStream_t stream) {
  if (N <= 0 || D <= 0 || Dp < D || Dp % MKD) return cudaErrorInvalidValue;
  stage_bf16_kernel<<<(N + STAGE_ROWS - 1) / STAGE_ROWS, THREADS, 0, stream>>>(
      src, N, D, Dp, out, norms);
  return cudaGetLastError();
}

// The exact tile's prologue: norms (N,) f32 of rows [0, N) of `src` after
// its decode. One warp per 16-row group: each 8-deep k-step loads the
// group's A fragment straight from device memory (the B fragments of the
// group's two 8-column blocks are the same values), splits it, and runs the
// tile's passes and accumulation (Tf32x3, mma_step) over the same k extent
// (D rounded up to TKD, zeros past D); a row's norm is its diagonal entry.
template <class Src>
__global__ void __launch_bounds__(THREADS)
stage_tf32_kernel(Src src, int N, int D, float* __restrict__ norms) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = (blockIdx.x * (THREADS / 32) + warp) * 16;
  if (r0 >= N) return;
  const int g = lane / 4, t = lane % 4;
  const int ra = r0 + g, rb = r0 + g + 8;
  const int Dk = (D + TKD - 1) / TKD * TKD;
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < Dk; k0 += 8) {
    auto at = [&](int row, int dim) {
      return row < N && dim < D ? __float_as_uint(src.load(row, dim)) : 0u;
    };
    // a0 (ra, t), a1 (rb, t), a2 (ra, t+4), a3 (rb, t+4); the columns of
    // block 0 are rows r0..r0+7 (b0 = a0, b1 = a2), of block 1 rows
    // r0+8..r0+15 (b0 = a1, b1 = a3)
    const unsigned x[4] = {at(ra, k0 + t), at(rb, k0 + t), at(ra, k0 + t + 4),
                           at(rb, k0 + t + 4)};
    Tf32x3::AFrag a;
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32_norm(x[j], a.hi[j], a.lo[j]);
    const Tf32x3::BFrag b0{{a.hi[0], a.hi[2]}, {a.lo[0], a.lo[2]}};
    const Tf32x3::BFrag b1{{a.hi[1], a.hi[3]}, {a.lo[1], a.lo[3]}};
    mma_step<Tf32x3>(c0, a, b0);
    mma_step<Tf32x3>(c1, a, b1);
  }
  // entry (g, 2t + j) of block 0 and (g + 8, 8 + 2t + j) of block 1 lie on
  // the diagonal when g == 2t + j
  if (g == 2 * t || g == 2 * t + 1) {
    const int j = g - 2 * t;
    if (ra < N) norms[ra] = c0[j];
    if (rb < N) norms[rb] = c1[2 + j];
  }
}

template <class Src>
cudaError_t stage_tf32(const Src& src, int N, int D, float* norms, cudaStream_t stream) {
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  constexpr int rows_per_cta = 16 * (THREADS / 32);
  stage_tf32_kernel<<<(N + rows_per_cta - 1) / rows_per_cta, THREADS, 0, stream>>>(
      src, N, D, norms);
  return cudaGetLastError();
}

}  // namespace knn

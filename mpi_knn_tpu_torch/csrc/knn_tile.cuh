// The tile routines shared by the fused kNN kernels (fused_knn.cu) and the
// ring block-merge kernels (fused_ring.cu), for Hopper (sm_90a). Two tiles:
//
// `sweep`, the exact tile. One CTA owns QB = 64 query rows and sweeps a
// range of corpus columns in chunks of CB = 64. Per chunk it forms the
// 64 x 64 squared-L2 tile q^2 - 2 q.c + c^2 in full f32 with an SGEMM-style
// register tile (4 x 4 outputs per thread, 32-deep slices of the width
// staged in shared memory). Operations bound it: FFMA at the FP32 peak.
//
// `sweep_bf16`, the compress tile (the mixed policy's pass 1). Its operands
// are bf16 copies made once by the staging prologue (`stage_bf16_kernel`:
// one pass per row set writing the copy rounded to nearest even, zero-padded
// to a multiple of MKD, and the f32 squared norm of the unrounded row). One
// CTA owns MQB = 128 query rows and sweeps columns in chunks of MCB = 128;
// 8 warps each hold a 64 x 32 block of f32 accumulators and run
// mma.sync m16n8k16 bf16 on the tensor cores, fed by ldmatrix from a
// 3-stage cp.async ring of 32-deep slices (rows padded to 40 bf16, so
// ldmatrix meets no bank conflict). A bf16 x bf16 product is exact in f32,
// so the keys are the bf16 dot with f32 sums (the tensor cores' own sum
// order). What bounds it: the products need ~5.7 ms at the bf16 tensor
// peak for the 60k main path, so the selection outweighs the product. The
// tile keeps the keys in shared memory (Ds aliases the staging ring once
// the K loop ends) so only the survivors reach device memory, and for
// k <= 64 a row whose keys all lose to its list's worst costs one compare
// per key, while a row with winners takes its list into the warp's
// registers (RegList) and inserts with shuffles, not shared-memory shifts
// and warp barriers.
//
// Both tiles mask each key and offer every column to the row's ascending
// list of the k best candidates, ordered lexicographically by (distance,
// key); keys are unique, so the lists do not depend on the order of the
// offers. What a column's value, mask and key are is the caller's policy
// (the `Src` template argument):
//
//   float load(int col, int dim)   the corpus element after its wire decode
//                                  (read by `sweep` and by the prologue)
//   bool masked(int row, int col, float d, float qs, float cs)
//   int key(int col)               the tie order and what the list stores
//   static constexpr bool clamp     max(d, 0), keeping NaN
//   static constexpr bool nan_as_inf  a NaN key is +inf (else it poisons
//                                     the row)
//
// Numerics. q^2 and c^2 are summed with the same FMA order as the exact dot
// (one accumulator, dims ascending) from the unrounded f32 values, so an
// exact duplicate pair gives q^2 - 2 q.c + c^2 == 0 bit for bit in exact
// mode; the prologue sums in that order too.
//
// Lists live in shared memory for k <= KMAX_SMEM, else in a global buffer
// the caller names; the same code runs through generic pointers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int QB = 64;        // query rows per CTA
constexpr int CB = 64;        // corpus columns per chunk
constexpr int KD = 32;        // depth of one staged slice
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps float4 alignment of smem rows
constexpr int KMAX_SMEM = 128;
constexpr unsigned FULL = 0xffffffffu;
static_assert(QB == CB, "the staging loop loads query and corpus rows together");

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

// Shared memory of one CTA, carved from the dynamic allocation.
struct Smem {
  float* As;   // [KD][QB+PAD] query slice
  float* Bs;   // [KD][CB+PAD] corpus slice
  float* Ds;   // [QB][CB+1] masked tile
  float* qn;   // [QB]
  float* cn;   // [CB]
  int* nanf;   // [QB] row saw a NaN
  float* Lsd;  // [QB][k] lists (k <= KMAX_SMEM)
  int* Lsi;
};

__device__ inline Smem carve(unsigned char* smem, int k) {
  Smem s;
  s.As = reinterpret_cast<float*>(smem);
  s.Bs = s.As + KD * (QB + PAD);
  s.Ds = s.Bs + KD * (CB + PAD);
  s.qn = s.Ds + QB * (CB + 1);
  s.cn = s.qn + QB;
  s.nanf = reinterpret_cast<int*>(s.cn + CB);
  s.Lsd = reinterpret_cast<float*>(s.nanf + QB);
  s.Lsi = reinterpret_cast<int*>(s.Lsd + QB * k);
  return s;
}

inline size_t smem_bytes(int k) {
  size_t b = sizeof(float) * (KD * (QB + PAD) + KD * (CB + PAD) +
                              QB * (CB + 1) + QB + CB) +
             sizeof(int) * QB;
  if (k <= KMAX_SMEM) b += (sizeof(float) + sizeof(int)) * (size_t)QB * k;
  return b;
}

// Where the k-list of the CTA's row r lives: shared memory for small k,
// else row (row0 + r) of a (rows, k) global buffer.
struct Lists {
  Smem sm;
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

// Every list of the CTA filled with (+inf, sentinel) and the NaN flags
// cleared. A sentinel of -1 keeps +inf candidates out of the lists; a
// sentinel of INT_MAX lets them in, in key order. ROWS is the CTA's query
// rows (QB for the exact tile, MQB for the compress tile).
template <int ROWS = QB, class LT>
__device__ inline void init_lists(const LT& L, int q0, int Q, int sentinel) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    if (q0 + r >= Q) continue;
    float* Ld = L.d(r);
    int* Li = L.i(r);
    for (int j = lane; j < L.k; j += 32) { Ld[j] = inf_f(); Li[j] = sentinel; }
    if (lane == 0) L.sm.nanf[r] = 0;
  }
  __syncthreads();
}

// The CTA's query rows [q0, q0+QB) against corpus columns [c_begin, c_end),
// offered to the lists. q is (Q, D) f32.
template <class Src>
__device__ void sweep(const Src& src, const float* __restrict__ q, int Q,
                      int D, int q0, int c_begin, int c_end, const Lists& L) {
  const Smem& sm = L.sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int k = L.k;

  for (int col0 = c_begin; col0 < c_end; col0 += CB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float nacc = 0.f;  // tid < CB: ||c||^2; CB <= tid < CB+QB: ||q||^2
    const bool first = col0 == c_begin;

    // The staging and FMA loops unroll fully, so loads run ahead of their
    // use; with an 8-deep unroll K1 and K2 ran ~5 % slower on the H100.
    for (int k0 = 0; k0 < D; k0 += KD) {
      __syncthreads();
#pragma unroll
      for (int e = tid; e < QB * KD; e += THREADS) {
        int r = e / KD, dd = e % KD;
        int row = q0 + r, dim = k0 + dd;
        sm.As[dd * (QB + PAD) + r] =
            (row < Q && dim < D) ? q[(size_t)row * D + dim] : 0.f;
        int col = col0 + r;
        sm.Bs[dd * (CB + PAD) + r] =
            (col < c_end && dim < D) ? src.load(col, dim) : 0.f;
      }
      __syncthreads();
      // norms in the dot's FMA order, from the unrounded values (zero
      // padding past D adds exact zeros)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        float4 a = *reinterpret_cast<const float4*>(&sm.As[kk * (QB + PAD) + ty * 4]);
        float4 b = *reinterpret_cast<const float4*>(&sm.Bs[kk * (CB + PAD) + tx * 4]);
        float av[4] = {a.x, a.y, a.z, a.w};
        float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      // norms in the dot's FMA order (zero padding past D adds exact zeros)
      if (tid < CB) {
        for (int kk = 0; kk < KD; ++kk) {
          float v = sm.Bs[kk * (CB + PAD) + tid];
          nacc = fmaf(v, v, nacc);
        }
      } else if (first && tid < CB + QB) {
        for (int kk = 0; kk < KD; ++kk) {
          float v = sm.As[kk * (QB + PAD) + tid - CB];
          nacc = fmaf(v, v, nacc);
        }
      }
    }
    if (tid < CB) sm.cn[tid] = nacc;
    else if (first && tid < CB + QB) sm.qn[tid - CB] = nacc;
    __syncthreads();

    // masked distances -> Ds
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = ty * 4 + i;
      int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int cc = tx * 4 + j;
        int col = col0 + cc;
        float qs = sm.qn[r], cs = sm.cn[cc];
        float d = __fadd_rn(__fsub_rn(qs, __fmul_rn(2.f, acc[i][j])), cs);
        if (src.clamp) d = d < 0.f ? 0.f : d;  // max(d, 0) that keeps NaN
        bool invalid = col >= c_end || row >= Q ||
                       src.masked(row, col, d, qs, cs);
        sm.Ds[r * (CB + 1) + cc] = invalid ? inf_f() : d;
      }
    }
    __syncthreads();

    // selection: warp w owns rows w, w+8, ...; each lane two columns
    for (int r = warp; r < QB; r += THREADS / 32) {
      if (q0 + r >= Q) continue;
      float* Ld = L.d(r);
      int* Li = L.i(r);
      bool any_nan = false;
      for (int h = 0; h < 2; ++h) {
        int cc = lane + 32 * h;
        int col = col0 + cc;
        float d = sm.Ds[r * (CB + 1) + cc];
        if (src.nan_as_inf && d != d) d = inf_f();
        any_nan |= warp_offer(Ld, Li, k, d, src.key(col), col < c_end, lane);
      }
      if (any_nan && lane == 0) sm.nanf[r] = 1;
      __syncwarp();
    }
  }
  __syncthreads();
}

inline cudaError_t set_smem(const void* kernel, int k) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(k));
}

// ------------------------------------------------------------ compress tile

constexpr int MQB = 128;           // query rows per CTA
constexpr int MCB = 128;           // columns per chunk
constexpr int MKD = 32;            // depth of one staged slice (bf16)
constexpr int MSTAGES = 3;         // cp.async ring
constexpr int MPITCH = MKD + 8;    // smem row pitch: 80 B, ldmatrix conflict-free
constexpr int MDS = MCB + 1;       // key tile row pitch
constexpr int STAGE_ROWS = 32;     // rows per CTA of the staging prologue
static_assert(THREADS == 256, "8 warps: 2 x 4 warp tiles of 64 x 32");

typedef __nv_bfloat16 bf16;

// A row set at f32 (queries, or a dense corpus), for the prologue.
struct F32Rows {
  const float* x;
  int D;
  __device__ float load(int row, int dim) const { return x[(size_t)row * D + dim]; }
};

// The staging prologue: rows [0, N) of `src` -> out (N, Dp) bf16, rounded
// to nearest even and zero-padded past D, and norms (N,) f32, the squared
// norm of the unrounded row summed with one fmaf accumulator over the dims
// in ascending order (the exact tile's order). One CTA per STAGE_ROWS rows.
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// Shared memory of one compress CTA: the staging ring (As, Bs) and the key
// tile Ds share one region, used in turn.
struct MmaSmem {
  bf16* As;    // [MSTAGES][MQB][MPITCH]
  bf16* Bs;    // [MSTAGES][MCB][MPITCH]
  float* Ds;   // [MQB][MDS]
  float* qn;   // [MQB]
  float* cn;   // [MCB]
  int* nanf;   // [MQB]
  float* Lsd;  // [MQB][k] (k <= KMAX_SMEM)
  int* Lsi;
};

constexpr size_t MSTAGE_BYTES = sizeof(bf16) * MSTAGES * (MQB + MCB) * MPITCH;
constexpr size_t MDS_BYTES = sizeof(float) * MQB * MDS;
constexpr size_t MREGION =
    ((MSTAGE_BYTES > MDS_BYTES ? MSTAGE_BYTES : MDS_BYTES) + 15) / 16 * 16;

__device__ inline MmaSmem carve_mma(unsigned char* smem, int k) {
  MmaSmem s;
  s.As = reinterpret_cast<bf16*>(smem);
  s.Bs = s.As + MSTAGES * MQB * MPITCH;
  s.Ds = reinterpret_cast<float*>(smem);
  s.qn = reinterpret_cast<float*>(smem + MREGION);
  s.cn = s.qn + MQB;
  s.nanf = reinterpret_cast<int*>(s.cn + MCB);
  s.Lsd = reinterpret_cast<float*>(s.nanf + MQB);
  s.Lsi = reinterpret_cast<int*>(s.Lsd + MQB * k);
  return s;
}

inline size_t mma_smem_bytes(int k) {
  size_t b = MREGION + sizeof(float) * (MQB + MCB) + sizeof(int) * MQB;
  if (k <= KMAX_SMEM) b += (sizeof(float) + sizeof(int)) * (size_t)MQB * k;
  return b;
}

inline cudaError_t set_mma_smem(const void* kernel, int k) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)mma_smem_bytes(k));
}

// Registers and local (spilled) bytes a thread, and CTAs per SM, of a
// compress kernel at list width k.
inline cudaError_t mma_kernel_info(const void* kernel, int k, int* regs,
                                   int* local_bytes, int* ctas_per_sm) {
  cudaError_t err = set_mma_smem(kernel, k);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, THREADS,
                                                        mma_smem_bytes(k));
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// The compress CTA's lists: shared memory for small k, else row
// (row0 + r) of a (rows, k) global buffer.
struct MmaLists {
  MmaSmem sm;
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

// The CTA's query rows [q0, q0+MQB) against columns [c_begin, c_end),
// offered to the lists. qb (Q, Dp) / cb (C, Dp) are the prologue's bf16
// copies and qn / cn its norms; Dp is a multiple of MKD.
template <class Src>
__device__ void sweep_bf16(const Src& src, const bf16* __restrict__ qb,
                           const float* __restrict__ qn, int Q,
                           const bf16* __restrict__ cb,
                           const float* __restrict__ cn, int Dp, int q0,
                           int c_begin, int c_end, const MmaLists& L) {
  const MmaSmem& sm = L.sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile rows wm*64, cols wn*32
  const int nk = Dp / MKD;
  const int k = L.k;
  for (int r = tid; r < MQB; r += THREADS) sm.qn[r] = q0 + r < Q ? qn[q0 + r] : 0.f;

  for (int col0 = c_begin; col0 < c_end; col0 += MCB) {
    for (int c = tid; c < MCB; c += THREADS)
      sm.cn[c] = col0 + c < c_end ? cn[col0 + c] : 0.f;

    // slice kt of the query and column rows into ring slot kt % MSTAGES;
    // rows past Q or c_end are zero-filled
    auto stage = [&](int kt) {
      bf16* as = sm.As + (kt % MSTAGES) * MQB * MPITCH;
      bf16* bs = sm.Bs + (kt % MSTAGES) * MCB * MPITCH;
      constexpr int CHUNKS = MKD / 8;  // 16-byte chunks per row slice
#pragma unroll
      for (int i = 0; i < (MQB + MCB) * CHUNKS / THREADS; ++i) {
        int e = tid + i * THREADS;
        int r = e / CHUNKS, ch = e % CHUNKS;
        bool is_q = r < MQB;
        int rr = is_q ? r : r - MQB;
        int g = is_q ? q0 + rr : col0 + rr;
        bool valid = is_q ? g < Q : g < c_end;
        const bf16* base = is_q ? qb : cb;
        const bf16* from = valid ? base + (size_t)g * Dp + kt * MKD + ch * 8 : base;
        cp_async16((is_q ? as : bs) + rr * MPITCH + ch * 8, from, valid);
      }
    };

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
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
      const bf16* as = sm.As + (kt % MSTAGES) * MQB * MPITCH;
      const bf16* bs = sm.Bs + (kt % MSTAGES) * MCB * MPITCH;
#pragma unroll
      for (int ks = 0; ks < MKD; ks += 16) {
        unsigned a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(a[mi], as + (wm * 64 + mi * 16 + lane % 16) * MPITCH + ks +
                                 (lane / 16) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4(r, bs + (wn * 32 + nj * 16 + (lane / 16) * 8 + lane % 8) * MPITCH +
                             ks + ((lane / 8) % 2) * 8);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained and read: Ds may overwrite it

    // masked keys -> Ds. Accumulator j of (mi, ni) sits at row
    // lane/4 + 8*(j/2), column 2*(lane%4) + j%2 of that 16 x 8 block.
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int r = wm * 64 + mi * 16 + lane / 4 + 8 * (j / 2);
          int cc = wn * 32 + ni * 8 + 2 * (lane % 4) + j % 2;
          int row = q0 + r, col = col0 + cc;
          float qs = sm.qn[r], cs = sm.cn[cc];
          float d = __fadd_rn(__fsub_rn(qs, __fmul_rn(2.f, acc[mi][ni][j])), cs);
          if (src.clamp) d = d < 0.f ? 0.f : d;  // max(d, 0) that keeps NaN
          bool invalid = col >= c_end || row >= Q || src.masked(row, col, d, qs, cs);
          sm.Ds[r * MDS + cc] = invalid ? inf_f() : d;
        }
    __syncthreads();

    // selection: warp w owns rows w, w+8, ...; each lane four columns. For
    // k <= 64 a row whose keys all lose to its list's worst entry costs one
    // compare per key; otherwise its list is taken into registers and the
    // winners inserted there (RegList), then written back.
    constexpr int H = MCB / 32;
    for (int r = warp; r < MQB; r += THREADS / 32) {
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
        float d = sm.Ds[r * MDS + cc];
        if (src.nan_as_inf && d != d) d = inf_f();
        cd[h] = d;
        ck[h] = src.key(col);
        act[h] = col < c_end;
        nan_here |= act[h] && d != d;
      }
      if (__any_sync(FULL, nan_here) && lane == 0) sm.nanf[r] = 1;
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
            R.insert(k, __shfl_sync(FULL, cd[h], from),
                     __shfl_sync(FULL, ck[h], from), lane);
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
    __syncthreads();  // Ds is read before the next chunk's ring overwrites it
  }
  __syncthreads();
}

}  // namespace knn

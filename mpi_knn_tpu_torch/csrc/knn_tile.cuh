// The tile routine shared by the fused kNN kernels (fused_knn.cu) and the
// ring block-merge kernels (fused_ring.cu), for Hopper (sm_90a).
//
// One CTA owns QB = 64 query rows and sweeps a range of corpus columns in
// chunks of CB = 64. Per chunk it forms the 64 x 64 squared-L2 tile
// q^2 - 2 q.c + c^2 with an SGEMM-style register tile (4 x 4 outputs per
// thread, 32-deep slices of the width staged in shared memory), masks it,
// and offers every column to the row's ascending list of the k best
// candidates, ordered lexicographically by (distance, key). What a column's
// value, mask and key are is the caller's policy (the `Src` template
// argument):
//
//   float load(int col, int dim)   the corpus element after its wire decode
//   bool masked(int row, int col, float d, float qs, float cs)
//   int key(int col)               the tie order and what the list stores
//   static constexpr bool compress  bf16-round both dot operands
//   static constexpr bool clamp     max(d, 0), keeping NaN
//   static constexpr bool nan_as_inf  a NaN key is +inf (else it poisons
//                                     the row)
//
// Numerics. q^2 and c^2 are summed in-kernel with the same FMA order as the
// dot (one accumulator, dims ascending) from the unrounded f32 values, so an
// exact duplicate pair gives q^2 - 2 q.c + c^2 == 0 bit for bit in exact
// mode. With `compress`, the staged slices are rounded to bf16 (half to
// even) after the norms have read them; a bf16 x bf16 product is exact in
// f32, so FFMA over the rounded values is the bf16 dot with f32 sums.
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
// sentinel of INT_MAX lets them in, in key order.
__device__ inline void init_lists(const Lists& L, int q0, int Q, int sentinel) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < QB; r += THREADS / 32) {
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
      auto add_norms = [&]() {
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
      };
      if constexpr (Src::compress) {
        add_norms();
        __syncthreads();  // the norms have read the unrounded slice
        for (int e = tid; e < KD * (QB + PAD); e += THREADS) {
          sm.As[e] = round_bf16(sm.As[e]);
          sm.Bs[e] = round_bf16(sm.Bs[e]);
        }
        __syncthreads();
      }
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
      if constexpr (!Src::compress) add_norms();
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

}  // namespace knn

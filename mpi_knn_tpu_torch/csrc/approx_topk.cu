// The TPU's partial top-k reduction for Hopper (sm_90a): a bin minimum.
//
// Replaces lax.approx_min_k as mpi_knn_tpu/ops/topk.py reaches it (:156
// with aggregate_to_topk=False for "approx-rerank", :176 for "approx").
// XLA lowers that op on a TPU to a partial reduction: the row's n columns
// fall into L bins, each bin keeps its minimum, and (aggregate on) an exact
// top-k of the L winners follows. L comes from XLA's reduction-size rule
// (ops/approx_topk.py::reduction_width). Bin b holds columns b, b + L,
// b + 2L, ... below n; the TPU does not document its own bin order, so this
// assignment is the port's.
//
// Order. Each (value, column) pair becomes one 64-bit key: the value's
// IEEE bits mapped to a signed order (-0.0 counted as +0.0, any NaN above
// +inf) in the high word, the column in the low word. Keys are unique, so
// a bin's minimum is its smallest value with ties to the lowest column,
// and the winners sort by (value, column) ascending: ties go to the
// leftmost column, as lax.top_k gives them.
//
// What bounds it. The row is read once and `out` (value, position) pairs
// are written once: bytes bound it (a 1024 x 2048 f32 tile: 8.4 MB, 2.5 us
// at 3.35 TB/s; the pallas merge's 60416 x 300 real columns: 72 MB, 22 us).
// So the keys stay in registers and a column costs a load and ~10
// instructions; what is left is the selection, which the design keeps to
// o rounds of warp minima where only o of the L winners are asked for.
//
// Design. A warp reduces a chunk of at most 128 G bins (G = 1, 2, 4, 8):
// lane l holds bins 4l..4l+3 of each 128-bin group, so one 16-byte load
// gives a lane its four bins' next columns (when L, the row stride and the
// base are multiples of 4 floats; else two 8-byte loads, or four) and a
// warp reads 512 contiguous bytes; a lane issues the loads of 4 / G
// segments of L columns before their keys. Then the chunk's o smallest:
//   o <= 32: each lane sorts its 4G keys in registers (Batcher's network,
//            constant indices), keeps its head and next key in registers
//            and the rest in shared memory, and o rounds of two warp
//            minima (redux.sync on the order word, then on the column
//            among the lanes that hold it) pop the warp's smallest head;
//   o > 32:  the warp sorts its 128 G keys in shared memory (bitonic).
// The launch plan (ops/approx_topk.py::launch_plan) picks one of three:
//   warp      L <= 1024: one chunk a row, a warp a row, 4 rows a CTA;
//   cta       L <= 8192: a CTA a row, one warp per chunk of <= 512 bins
//             (16 warps at most, so 128 registers a thread keep the keys);
//             o <= 32: warp 0 merges the warps' sorted lists from shared
//             memory by the same rounds; else the CTA sorts all minima in
//             shared memory (bitonic, the keys padded to a power of two);
//   two_pass  wider: warps write each chunk's sorted o smallest keys to a
//             global scratch the wrapper allocates, then merge passes
//             (a warp merges up to 32 lists by rounds) until one list a
//             row is left; the last pass writes the outputs.
// float64 (the reference's f64 debugging mode): the same plans on double
// rows, each key the value's 64 bits in the same signed order (-0.0 as
// +0.0, NaN above +inf) above the column, 96 bits in an unsigned __int128;
// a warp minimum takes three 32-bit rounds (the order's two words, then
// the column), and keys take 16 bytes of shared memory and scratch.
// Epilogue: the value is read back from the row (its own bits: -0.0 and
// NaN payloads stay); columns at or past `c` (the fused form's lane
// padding) are +inf. It writes int64 positions (approx_min_k), or gathers
// int32 ids, INVALID_ID where the value is +-inf (smallest_k's fused form).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalidId = -1;
constexpr int kWarpRows = 4;    // warps (rows) per CTA in the warp plan
constexpr int kCtaG = 4;        // 512 bins a warp in the cta plan
constexpr int kCtaMaxWarps = 16;  // warps a CTA in the cta plan (launch bounds)
constexpr int kTwoPassG = 8;    // 1024 bins a warp in the two-pass plan
constexpr int kMergeWarps = 4;  // warps per CTA of a merge pass

enum Regime { kWarp = 0, kCta = 1, kTwoPass = 2 };

// The key of a value type: f32 -> 64 bits (signed), f64 -> 96 bits in an
// unsigned __int128. kNone<K>() loses to every real key, NaN's too.
template <class T> struct KeyOf;
template <> struct KeyOf<float> { using type = long long; };
template <> struct KeyOf<double> { using type = unsigned __int128; };
template <class T> using Key = typename KeyOf<T>::type;

template <class K>
__host__ __device__ constexpr K kNone() {
  if constexpr (sizeof(K) == 8) return LLONG_MAX;
  else return ~(K)0;
}

template <class T>
struct Args {
  const T* d;
  long long ld;    // row stride of d, floats
  long long rows;
  int c;           // real columns; [c, n_pad) count as +inf
  int n_pad;       // the reduced width
  int L;           // bins
  int out;         // keys a row returns
  int chunk;       // bins a warp reduces
  int nch;         // chunks a row
  int vw;          // values a load: 4, 2 or 1 (alignment of L, ld, d)
  T* out_v;
  long long* out_pos;  // positions (approx_min_k), or null
  const int* ids;      // ids to gather (fused form), or null
  long long ids_ld;    // row stride of ids (0: one row for all)
  int* out_ids;
};

__device__ __forceinline__ long long key_of(float v, int col) {
  int s = __float_as_int(v + 0.0f);      // -0.0 + 0.0 = +0.0
  int o = s ^ ((s >> 31) & 0x7fffffff);  // signed order of the IEEE bits
  o = v != v ? 0x7fffffff : o;           // NaN above +inf
  return (long long)(((unsigned long long)(unsigned)o << 32) | (unsigned)col);
}

// The f64 key: the value's bits in an unsigned order (negative values
// complemented, others with the sign bit set; -0.0 as +0.0, NaN as the
// largest order) above the column.
__device__ __forceinline__ unsigned __int128 key_of(double v, int col) {
  unsigned long long u = (unsigned long long)__double_as_longlong(v + 0.0);
  u = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
  u = v != v ? ~0ull : u;
  return ((unsigned __int128)u << 32) | (unsigned)col;
}

template <class T, class K>
__device__ __forceinline__ void keep_min(K& m, T v, int col) {
  K k = key_of(v, col);
  m = k < m ? k : m;
}

// A lane's four consecutive columns p[0..3] by loads of VW values, at
// most 16 bytes a load (the caller checked the alignment).
template <int VW>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  if constexpr (VW == 4) {
    float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VW == 2) {
    float2 t0 = __ldg(reinterpret_cast<const float2*>(p));
    float2 t1 = __ldg(reinterpret_cast<const float2*>(p + 2));
    v[0] = t0.x, v[1] = t0.y, v[2] = t1.x, v[3] = t1.y;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __ldg(p + e);
  }
}

template <int VW>
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  if constexpr (VW >= 2) {
    double2 t0 = __ldg(reinterpret_cast<const double2*>(p));
    double2 t1 = __ldg(reinterpret_cast<const double2*>(p + 2));
    v[0] = t0.x, v[1] = t0.y, v[2] = t1.x, v[3] = t1.y;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __ldg(p + e);
  }
}

// Lane l's minima of bins bin0 + 128 g + 4 l + e of row dr into
// m[4 g + e], over the segments of L columns, U at a time with all their
// loads issued before their keys, so that a lane keeps 4 G U >= 16 floats
// in flight. Batches whose every column is below c take one load4 per
// group and no checks, where bin_end is a multiple of 4 (bin0 always is),
// so that a group below bin_end has all four bins; the rest take four
// columns by one load4 below c, else each column alone (+inf from c to
// n_pad), and keep only bins below bin_end.
template <class T, int G, int VW>
__device__ __forceinline__ void segments(const Args<T>& a, const T* dr,
                                         int bin0, int bin_end, int lane,
                                         Key<T> (&m)[4 * G]) {
  constexpr int U = G >= 4 ? 1 : 4 / G;
  const int b0 = bin0 + 4 * lane;
  const bool whole_groups = (bin_end & 3) == 0;
  int base = 0;  // the column of bin 0 in the batch's first segment
  for (; whole_groups && base + (U - 1) * a.L + bin_end <= a.c;
       base += U * a.L) {
    T v[U][G][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (b0 + 128 * g < bin_end)
          load4<VW>(dr + base + u * a.L + b0 + 128 * g, v[u][g]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (b0 + 128 * g < bin_end)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            keep_min(m[4 * g + e], v[u][g][e], base + u * a.L + b0 + 128 * g + e);
  }
  for (; base + bin0 < a.n_pad; base += U * a.L) {
    T v[U][G][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = base + u * a.L + b0 + 128 * g;
        if (col + 3 < a.c) {
          load4<VW>(dr + col, v[u][g]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[u][g][e] = col + e < a.c ? __ldg(dr + col + e) : (T)INFINITY;
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = b0 + 128 * g + e;
          const int col = base + u * a.L + b;
          if (b < bin_end && col < a.n_pad) keep_min(m[4 * g + e], v[u][g][e], col);
        }
  }
}

// The chunk [bin0, bin_end) of row `dr`: lane l's minima of bins
// bin0 + 128 g + 4 l + e into m[4 g + e]; kNone where there is no bin.
template <class T, int G>
__device__ __forceinline__ void chunk_minima(const Args<T>& a, const T* dr,
                                             int bin0, int bin_end, int lane,
                                             Key<T> (&m)[4 * G]) {
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) m[i] = kNone<Key<T>>();
  if (sizeof(T) == 4 && a.vw == 4)
    segments<T, G, 4>(a, dr, bin0, bin_end, lane, m);
  else if (a.vw >= 2)
    segments<T, G, 2>(a, dr, bin0, bin_end, lane, m);
  else
    segments<T, G, 1>(a, dr, bin0, bin_end, lane, m);
}

// Ascending sort of a lane's registers: Batcher's odd-even merge sort
// (19 compare-exchanges for 8 keys), constant indices only.
template <int B, class K>
__device__ __forceinline__ void sort_lane(K (&m)[B]) {
#pragma unroll
  for (int p = 1; p < B; p <<= 1)
#pragma unroll
    for (int k = p; k >= 1; k >>= 1)
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (i + k < B && i >= k % p && (i - k % p) % (2 * k) < k &&
            i / (2 * p) == (i + k) / (2 * p)) {
          K x = m[i], y = m[i + k];
          m[i] = x < y ? x : y;
          m[i + k] = x < y ? y : x;
        }
}

// One round over the warp's heads: the smallest key of the warp, and
// whether this lane holds it. Two 32-bit warp minima: the order word, then
// the column among the lanes holding that order.
__device__ __forceinline__ long long warp_min(long long head, bool& mine) {
  int hi = (int)(head >> 32);
  int mh = __reduce_min_sync(kFull, hi);
  unsigned lo = hi == mh ? (unsigned)head : 0xffffffffu;
  unsigned ml = __reduce_min_sync(kFull, lo);
  mine = hi == mh && (unsigned)head == ml;
  return (long long)(((unsigned long long)(unsigned)mh << 32) | ml);
}

// The same for 96-bit keys: three 32-bit warp minima, the order's high
// word, its low word, then the column.
__device__ __forceinline__ unsigned __int128 warp_min(unsigned __int128 head, bool& mine) {
  const unsigned w2 = (unsigned)(head >> 64), w1 = (unsigned)(head >> 32),
                 w0 = (unsigned)head;
  const unsigned m2 = __reduce_min_sync(kFull, w2);
  const unsigned m1 = __reduce_min_sync(kFull, w2 == m2 ? w1 : 0xffffffffu);
  const bool top = w2 == m2 && w1 == m1;
  const unsigned m0 = __reduce_min_sync(kFull, top ? w0 : 0xffffffffu);
  mine = top && w0 == m0;
  return ((unsigned __int128)m2 << 64) | ((unsigned __int128)m1 << 32) | m0;
}

// The warp's o <= 32 smallest keys from lanes' sorted registers: lane r
// returns the r-th (kNone past o). A lane keeps its head and the key after
// it in registers, the rest in its column of the warp's 32 x B keys of
// shared memory, so a pop moves two keys and loads one.
template <int B, class K>
__device__ __forceinline__ K select_rounds(const K (&m)[B], K* s, int o, int lane) {
#pragma unroll
  for (int i = 2; i < B; ++i) s[32 * i + lane] = m[i];
  __syncwarp();
  K head = m[0], next = B > 1 ? m[1] : kNone<K>(), kept = kNone<K>();
  int p = 2;
  for (int r = 0; r < o; ++r) {
    bool pop;
    K key = warp_min(head, pop);
    if (lane == r) kept = key;
    if (pop) {
      head = next;
      next = p < B ? s[32 * p + lane] : kNone<K>();
      ++p;
    }
  }
  return kept;
}

// Ascending bitonic sort of s[0, n), n a power of two, by threads t of nt;
// `block` syncs the CTA between steps, else the warp.
template <class K>
__device__ void sort_shared(K* s, int n, int t, int nt, bool block) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = t; p < n / 2; p += nt) {
        int i = 2 * p - (p & (stride - 1));
        int j = i + stride;
        K x = s[i], y = s[j];
        if ((y < x) == ((i & size) == 0)) {
          s[i] = y;
          s[j] = x;
        }
      }
      if (block)
        __syncthreads();
      else
        __syncwarp();
    }
  }
}

// Output r of `row` for `key`: the value (+inf at or past c), and its
// position or its id.
template <class T>
__device__ __forceinline__ void emit(const Args<T>& a, long long row,
                                     const T* dr, int r, Key<T> key) {
  unsigned col = (unsigned)key;
  T v = col < (unsigned)a.c ? __ldg(dr + col) : (T)INFINITY;
  long long o = row * a.out + r;
  a.out_v[o] = v;
  if (a.out_pos) a.out_pos[o] = (long long)col;
  if (a.out_ids)
    a.out_ids[o] = isinf(v) ? kInvalidId : __ldg(a.ids + row * a.ids_ld + col);
}

// One warp's item: chunk `item % nch` of row `item / nch`, its o smallest
// keys to the outputs (nch = 1) or, sorted, to `lists` (the two-pass
// plan's first pass). s: the warp's 128 G keys of shared memory.
template <class T, int G>
__device__ __forceinline__ void warp_item(const Args<T>& a, long long item,
                                          Key<T>* lists, int list_len,
                                          Key<T>* s, int lane) {
  const long long row = item / a.nch;
  const int bin0 = (int)(item % a.nch) * a.chunk;
  const int bin_end = min(a.L, bin0 + a.chunk);
  const T* dr = a.d + row * a.ld;
  Key<T> m[4 * G];
  chunk_minima<T, G>(a, dr, bin0, bin_end, lane, m);
  const bool final = a.nch == 1;
  const int o = final ? a.out : list_len;
  if (o <= 32) {
    sort_lane<4 * G>(m);
    Key<T> kept = select_rounds<4 * G>(m, s, o, lane);
    if (lane < o) {
      if (final)
        emit(a, row, dr, lane, kept);
      else
        lists[item * o + lane] = kept;
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[128 * g + 4 * lane + e] = m[4 * g + e];
  __syncwarp();
  sort_shared(s, 128 * G, lane, 32, false);
  for (int r = lane; r < o; r += 32) {
    if (final)
      emit(a, row, dr, r, s[r]);
    else
      lists[item * o + r] = s[r];
  }
}

// warp plan and the two-pass plan's first pass: a warp an item.
template <class T, int G>
__global__ void warp_chunks_kernel(Args<T> a, Key<T>* lists, int list_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Key<T>* smem = reinterpret_cast<Key<T>*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item < a.rows * a.nch)
    warp_item<T, G>(a, item, lists, list_len, smem + warp * (128 * G), lane);
}

// cta plan: a CTA a row, warp w reduces chunk w. Shared memory: each
// warp's 128 G keys (its lists for the rounds, or its part of the sort),
// then the warps' out smallest for warp 0's merge.
template <class T, int G>
__global__ void __launch_bounds__(32 * kCtaMaxWarps)
    cta_row_kernel(Args<T> a, int sort_width) {
  using K = Key<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* smem = reinterpret_cast<K*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x;
  const int bin0 = warp * a.chunk;
  const int bin_end = min(a.L, bin0 + a.chunk);
  const T* dr = a.d + row * a.ld;
  K m[4 * G];
  chunk_minima<T, G>(a, dr, bin0, bin_end, lane, m);
  K* s = smem + warp * (128 * G);
  if (a.out <= 32) {  // each warp's out smallest, merged by warp 0
    K* lists = smem + a.nch * (128 * G);
    sort_lane<4 * G>(m);
    lists[warp * 32 + lane] = select_rounds<4 * G>(m, s, a.out, lane);
    __syncthreads();
    if (warp != 0) return;
    const K* list = lists + lane * 32;
    const bool has = lane < a.nch;
    int next = 1;
    K head = has ? list[0] : kNone<K>();
    K kept = kNone<K>();
    for (int r = 0; r < a.out; ++r) {
      bool pop;
      K key = warp_min(head, pop);
      if (lane == r) kept = key;
      if (pop) head = has && next < a.out ? list[next++] : kNone<K>();
    }
    if (lane < a.out) emit(a, row, dr, lane, kept);
    return;
  }
  // every minimum into shared memory, padded to sort_width, one sort
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[128 * g + 4 * lane + e] = m[4 * g + e];
  for (int i = a.nch * 128 * G + threadIdx.x; i < sort_width; i += blockDim.x)
    smem[i] = kNone<K>();
  __syncthreads();
  sort_shared(smem, sort_width, threadIdx.x, blockDim.x, true);
  for (int r = threadIdx.x; r < a.out; r += blockDim.x)
    emit(a, row, dr, r, smem[r]);
}

// two-pass plan, a merge pass: a row's nl sorted lists of len keys, in
// groups of 32, each merged by a warp into one list of out_len keys (or,
// when one group is left, into the outputs).
template <class T>
__global__ void merge_lists_kernel(Args<T> a, const Key<T>* in, int nl,
                                   int len, Key<T>* outl, int out_len) {
  using K = Key<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (nl + 31) / 32;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= a.rows * groups) return;
  const long long row = item / groups;
  const int l = (int)(item % groups) * 32 + lane;
  const bool has = l < nl;
  const K* src = in + (row * nl + l) * (long long)len;
  const bool final = groups == 1;
  const int rounds = final ? a.out : out_len;
  const T* dr = a.d + row * a.ld;
  int next = 2;  // the lane's next key to load, one kept ahead
  K head = has ? src[0] : kNone<K>();
  K ahead = has && len > 1 ? src[1] : kNone<K>();
  K kept = kNone<K>();
  for (int r = 0; r < rounds; ++r) {
    bool pop;
    K key = warp_min(head, pop);
    if (lane == (r & 31)) kept = key;
    if ((r & 31) == 31 || r == rounds - 1) {
      int r0 = r & ~31;
      if (lane <= (r & 31)) {
        if (final)
          emit(a, row, dr, r0 + lane, kept);
        else
          outl[item * out_len + r0 + lane] = kept;
      }
    }
    if (pop) {
      head = ahead;
      ahead = has && next < len ? src[next] : kNone<K>();
      ++next;
    }
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <class T, int G>
cudaError_t launch_warp_chunks(const Args<T>& a, Key<T>* lists, int list_len,
                               int shared, cudaStream_t stream) {
  if (shared > 48 * 1024) {  // f64 keys at G = 8
    cudaError_t e = cudaFuncSetAttribute(
        warp_chunks_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (e != cudaSuccess) return e;
  }
  long long grid = (a.rows * a.nch + kWarpRows - 1) / kWarpRows;
  warp_chunks_kernel<T, G><<<(unsigned)grid, 32 * kWarpRows, shared, stream>>>(
      a, lists, list_len);
  return cudaGetLastError();
}

template <class T, int G>
cudaError_t launch_cta_rows(const Args<T>& a, int sort_width, int shared,
                            cudaStream_t stream) {
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cta_row_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (e != cudaSuccess) return e;
  }
  cta_row_kernel<T, G><<<(unsigned)a.rows, 32 * a.nch, shared, stream>>>(
      a, sort_width);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_warp_chunks_g(int G, const Args<T>& a, Key<T>* lists,
                                 int list_len, int shared,
                                 cudaStream_t stream) {
  switch (G) {
    case 1: return launch_warp_chunks<T, 1>(a, lists, list_len, shared, stream);
    case 2: return launch_warp_chunks<T, 2>(a, lists, list_len, shared, stream);
    case 4: return launch_warp_chunks<T, 4>(a, lists, list_len, shared, stream);
    case 8: return launch_warp_chunks<T, 8>(a, lists, list_len, shared, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The launch of either value type (see approx_min_k_launch).
template <class T>
int launch(const T* d, long long ld, long long rows, int c, int n_pad, int L, int out,
           int regime, int G, int chunk, int nch, int shared, Key<T>* scratch,
           long long scratch_len, T* out_v, long long* out_pos, const int* ids,
           long long ids_ld, int* out_ids, cudaStream_t stream) {
  using K = Key<T>;
  constexpr int kb = (int)sizeof(K);
  if (rows < 0 || c < 1 || c > n_pad || L < 1 || L > n_pad || out < 1 ||
      out > L || chunk < 1 || nch < 1 || (nch > 1 && chunk % 4 != 0) ||
      (long long)chunk * (nch - 1) >= L || (long long)chunk * nch < L ||
      (out_pos == nullptr) == (out_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  // a load takes at most 16 bytes: 4 floats or 2 doubles
  auto aligned = [&](int w) {
    return (int)sizeof(T) * w <= 16 && L % w == 0 && ld % w == 0 &&
           (uintptr_t)d % (sizeof(T) * w) == 0 && chunk % w == 0;
  };
  Args<T> a{d, ld, rows, c, n_pad, L, out, chunk, nch,
            aligned(4) ? 4 : aligned(2) ? 2 : 1, out_v, out_pos, ids, ids_ld,
            out_ids};
  const int warp_keys = kWarpRows * 128 * G;  // a warp's 128 G keys, 4 warps
  if (regime == kWarp) {
    if (nch != 1 || chunk > 128 * G || shared != warp_keys * kb)
      return (int)cudaErrorInvalidValue;
    return (int)launch_warp_chunks_g<T>(G, a, nullptr, 0, shared, stream);
  }
  if (regime == kCta) {
    int sort_width = out > 32 ? pow2_at_least(nch * 128 * G) : 0;
    int want = kb * (out > 32 ? sort_width : nch * (128 * G + 32));
    if (nch > kCtaMaxWarps || chunk > 128 * G || shared != want)
      return (int)cudaErrorInvalidValue;
    if (G != kCtaG) return (int)cudaErrorInvalidValue;
    return (int)launch_cta_rows<T, kCtaG>(a, sort_width, shared, stream);
  }
  if (regime != kTwoPass || G != kTwoPassG || chunk > 128 * G || nch < 2)
    return (int)cudaErrorInvalidValue;
  // level 0: each chunk's len smallest; then groups of 32 lists merge into
  // one of min(out, 32 len) keys until one group is left
  int len = out < chunk ? out : chunk;
  long long need = rows * nch * len;
  for (long long nl = nch, l = len; nl > 32;) {
    nl = (nl + 31) / 32;
    l = out < 32 * l ? out : 32 * l;
    need += rows * nl * l;
  }
  if (need != scratch_len || shared != warp_keys * kb)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_warp_chunks_g<T>(G, a, scratch, len, shared, stream);
  if (e != cudaSuccess) return (int)e;
  K* in = scratch;
  for (int nl = nch;;) {
    int groups = (nl + 31) / 32;
    int out_len = groups == 1 ? out : (out < 32 * len ? out : 32 * len);
    K* outl = in + rows * nl * (long long)len;
    long long grid = (rows * groups + kMergeWarps - 1) / kMergeWarps;
    merge_lists_kernel<T><<<(unsigned)grid, 32 * kMergeWarps, 0, stream>>>(
        a, in, nl, len, outl, out_len);
    e = cudaGetLastError();
    if (e != cudaSuccess || groups == 1) return (int)e;
    in = outl;
    nl = groups;
    len = out_len;
  }
}

}  // namespace

extern "C" {

// The bin minimum of `rows` rows of d (row stride ld floats; columns at or
// past c count as +inf up to n_pad), L bins, the `out` smallest winners
// sorted, by the plan launch_plan (ops/approx_topk.py) gives: regime,
// G (bins a lane holds / 4), chunk (bins a warp), nch (chunks a row),
// shared (dynamic shared bytes of the first kernel), scratch (int64 keys of
// the two-pass lists). Writes out_v (rows, out) f32 and out_pos (rows, out)
// int64 positions, or, with ids, out_ids (rows, out) int32: ids[row *
// ids_ld + position], INVALID_ID where the value is +-inf. Returns a CUDA
// error code; cudaErrorInvalidValue where the plan does not fit the shape.
int approx_min_k_launch(const float* d, long long ld, long long rows, int c,
                        int n_pad, int L, int out, int regime, int G,
                        int chunk, int nch, int shared, long long* scratch,
                        long long scratch_len, float* out_v,
                        long long* out_pos, const int* ids, long long ids_ld,
                        int* out_ids, cudaStream_t stream) {
  return launch<float>(d, ld, rows, c, n_pad, L, out, regime, G, chunk, nch, shared,
                       scratch, scratch_len, out_v, out_pos, ids, ids_ld, out_ids, stream);
}

// The same on f64 rows (ld in doubles): out_v (rows, out) f64; the plan's
// shared bytes and scratch count 16-byte keys (scratch: scratch_len keys).
int approx_min_k_f64_launch(const double* d, long long ld, long long rows, int c,
                            int n_pad, int L, int out, int regime, int G,
                            int chunk, int nch, int shared, void* scratch,
                            long long scratch_len, double* out_v,
                            long long* out_pos, const int* ids, long long ids_ld,
                            int* out_ids, cudaStream_t stream) {
  return launch<double>(d, ld, rows, c, n_pad, L, out, regime, G, chunk, nch, shared,
                        static_cast<unsigned __int128*>(scratch), scratch_len, out_v,
                        out_pos, ids, ids_ld, out_ids, stream);
}

}  // extern "C"

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
// Design. One CTA per row. Threads take bins b = threadIdx.x, +blockDim.x,
// ...: each walks its bin's columns, so a warp reads 32 neighbouring
// columns at a time (coalesced), and keeps the minimum key in registers.
// The L winners go to shared memory, padded with the largest key to P, the
// next power of two, and a bitonic network sorts them there; the first
// out_k keys are written (k, or all L). Shared memory bounds P at
// kMaxWidth (128 KB of keys); the wrapper refuses a wider L by name.
//
// What bounds it. The row is read once and out_k (value, position) pairs
// are written once: bytes bound it (a 1024 x 2048 f32 tile: 8.4 MB, 2.5 us
// at 3.35 TB/s). The sort's log2(P)(log2(P)+1)/2 steps of shared-memory
// compare-exchange run per row on P/2 threads.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWidth = 16384;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ long long order_key(float v, long long col) {
  if (v == 0.0f) v = 0.0f;  // -0.0 ranks with +0.0
  int s = __float_as_int(v);
  long long o = s >= 0 ? (long long)s : -(long long)(s & 0x7fffffff) - 1;
  if (v != v) o = 0x7fffffffLL;  // NaN above +inf
  return o * 4294967296LL + col;
}

__global__ void approx_min_k_kernel(const float* __restrict__ d,
                                    float* __restrict__ out_v,
                                    long long* __restrict__ out_c, int n,
                                    int L, int P, int out_k) {
  extern __shared__ long long keys[];
  const long long row = blockIdx.x;
  const float* dr = d + row * n;
  for (int b = threadIdx.x; b < P; b += blockDim.x) {
    long long best = LLONG_MAX;
    if (b < L) {
      best = order_key(dr[b], b);
      for (int c = b + L; c < n; c += L) {
        long long key = order_key(dr[c], c);
        best = key < best ? key : best;
      }
    }
    keys[b] = best;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        int i = 2 * t - (t & (stride - 1));
        int j = i + stride;
        long long a = keys[i], b = keys[j];
        bool ascending = (i & size) == 0;
        if ((a > b) == ascending) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < out_k; t += blockDim.x) {
    long long col = keys[t] & 0xffffffffLL;
    out_v[row * out_k + t] = dr[col];
    out_c[row * out_k + t] = col;
  }
}

}  // namespace

extern "C" {

int approx_min_k_max_width() { return kMaxWidth; }

// d (rows, n) f32 row-major; writes out_v (rows, out_k) f32 and out_c
// (rows, out_k) int64 column positions. 1 <= out_k <= L <= n, L <= 16384.
int approx_min_k_launch(const float* d, float* out_v, long long* out_c,
                        long long rows, int n, int L, int out_k,
                        cudaStream_t stream) {
  if (rows < 0 || rows > INT_MAX || L < 1 || L > n || L > kMaxWidth ||
      out_k < 1 || out_k > L)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int P = 1;
  while (P < L) P <<= 1;
  int threads = P / 2 < 32 ? 32 : (P / 2 > kMaxThreads ? kMaxThreads : P / 2);
  size_t smem = sizeof(long long) * (size_t)P;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        approx_min_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  approx_min_k_kernel<<<(unsigned)rows, threads, smem, stream>>>(
      d, out_v, out_c, n, L, P, out_k);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The ring's in-kernel transport for Hopper (sm_90a): the exact block merge
// of a ring round with the block's move to the ring successor inside the
// same launch.
//
// Replaces two kernels of mpi_knn_tpu/ops/pallas_ring.py:
//   round_dma_kernel_wgmma, round_dma_kernel_bf16, round_dma_kernel  <-
//       fused_round_dma (_dma_round_kernel, K4). One launch per card per
//       round, covering every ring rank that card holds. On the f32 wire
//       one persistent CTA per SM runs a wgmma tile over (local rank,
//       128-row query group) items: at "highest" knn_wgmma.cuh's on TF32
//       hi/lo planes of the queries and of the block (round_dma_kernel_wgmma),
//       at "default" / "high" knn_wgmma_bf16.cuh's on their bf16 planes
//       (round_dma_kernel_bf16<P>: one plane, or hi and lo); the producer
//       warpgroup's three spare warps run the transport: in CTA 0 one thread
//       the neighbour barrier, the others copy the resident block, its ids,
//       norms and planes into the successor's landing buffers in units spread
//       over the grid. On the bf16 and int8 wires (round_dma_kernel) CTA 0
//       runs the barrier, COPY_CTAS CTAs per rank stream the block, its ids
//       and (int8) its scales, and the rest are K3a's merge CTAs on
//       knn_tile.cuh's mma.sync tile, one per 128 (or 64) query rows. The
//       merges never wait on anything.
//   rotation_grid_kernel, rotation_grid_kernel_bf16  <- fused_rotation_grid
//       (_grid_rotation_kernel, K5). The whole P-round uni rotation in one
//       cooperative launch per card: persistent CTAs loop over (local rank,
//       query group) merges and the block's copy each round, with grid syncs
//       between rounds. Two slots per rank: round r reads slot r % 2 (round
//       0 the caller's block) and streams into the successor's slot (r + 1)
//       % 2. The carry lives in a (2, Q, k) ping-pong buffer between rounds.
//       rotation_grid_kernel (the bf16 wire, and the f32 one at "highest")
//       interleaves 64-row merge items on the mma.sync tile with copy items;
//       rotation_grid_kernel_bf16<P> (the f32 wire at "default" / "high")
//       runs the bf16 tile, one CTA per SM: each round the grid first writes
//       the resident block's planes and norms (and in round 0 the queries'
//       planes) into each rank's scratch on its own card, syncs, then merges
//       while the producer's spare warps copy the f32 block, ids and norms
//       on. The planes do not travel in K5: its slots, IPC exports and host
//       proxy hops stay those of the f32 wire.
//
// The merge is K3a's: the same (distance, arrival) order, NaN rows and zero
// rule, and its operand policy by matmul_precision. K5 at "highest" and K4's
// and K5's bf16 and int8 wires run ring_merge.cuh's exact_merge_group on
// knn_tile.cuh's tile (Tf32x3, or Bf16x1F32 / Bf16x3 at "default" / "high"),
// as K3a does; K4's f32 wire at "highest" runs the same merge (RoundEpi) on
// knn_wgmma.cuh's tile, built here with promotion every 8-deep k-step
// (KNN_WGMMA_PROMOTE 1), where its products, and its prologue's norms,
// equal the Tf32x3 tile's bit for bit (chip_smoke.py's
// wgmma_8deep_vs_mma_sync on the main shape). So at "highest" a K4 ring
// equals the driver-transport K3a ring bit for bit, and a K5 ring equals the
// K4 ring. At "default" / "high" on the f32 wire K4 and K5 run one merge
// (RingEpi) on one bf16 tile over planes of one prologue's bits
// (fused_knn's stage_planes; wgb::stage_planes8 in K5), so a K5 ring equals
// the K4 ring bit for bit; K3a keeps the mma.sync tile's sum order. A
// block's norms (and for K4's f32 forms its planes), written once per call
// by a prologue, travel with it as its ids do: the copy units, CTAs and work
// items move them too, so no round launches anything beside its kernel.
// K4's f32 prologue at "highest" (round_stage_split_launch) is
// knn_wgmma.cuh's stage_split_kernel at this file's interval, so its norms
// are the diagonal of K4's own tile.
//
// Transport. One process drives every rank of its part of the ring (all of
// it in one process). Ranks that share a card and a process are ordered by
// that card's stream and need no barrier: their "remote" copy is an
// in-kernel copy between buffers of one card. Between cards (peer access
// enabled by parallel/mesh.py), and for K5 between processes of one host
// (the successor's slots and flag words mapped by CUDA IPC,
// parallel/ipc.py, through the ring_ipc_* functions below; on one card or
// two), a kernel stores into the successor's buffers through its pointer
// with 16-byte vector stores,
// then __threadfence_system() and a system-scope release-add on one of the
// successor's int32 flag words; waiters spin with system-scope acquire loads.
// The flag words live on each card, one row of NWORDS per rank, allocated
// once per mesh, and only ever count up: a round (K4) or a call (K5) waits
// for the count its epoch implies, so they need no reset between calls.
//
//   K4 barrier: each rank adds one to its predecessor's FROM_SUCC and its
//   successor's FROM_PRED word, then waits for its own two words to reach
//   the epoch. The successor's landing slot for round r is the slot it read
//   as resident in round r - 1; its entering round r proves that launch
//   finished on its stream (the CUDA reading of pallas_ring.py:489-491).
//   Copies to a remote successor start only after the barrier thread has
//   passed the barrier (the `go` word). Before the kernel ends the barrier
//   thread waits for its own ranks' copy-out (SENT) and, from a remote
//   predecessor, the arrival (LANDED), as the last grid cell of
//   _dma_round_kernel does; the next round's launch then reads the landing
//   slot in stream order. Each rank signals COPY_CTAS times per round
//   either way: the bf16/int8 form once per copy CTA, the f32 forms once
//   per SPLIT copy units (counted on the rank's W_UNITS word).
//
//   K5 handshake (the reference's, :685-695, :736-749): one barrier per
//   call; before every stream after the first the sender consumes one
//   slot-free release of its successor, and after the grid sync that retires
//   round r's reads (its own copy-out included) a rank releases its slot to
//   its predecessor, except in the last two rounds. Before round r >= 1 a
//   rank waits for the predecessor's round r - 1 stream to have landed.
//   Slots are read with L1-bypassing loads (__ldcg): a slot is re-read in
//   the same launch two rounds after an earlier read, rewritten meanwhile by
//   a peer card or another SM, and neither an acquire by one thread nor a
//   grid sync drops other SMs' L1 lines. The bf16 form signals a hop's
//   COPY_CTAS landed adds once per SPLIT copy units (its G_UNITS word).
//
// No hang. Every spin is bounded by %globaltimer (timeout_ns, ~10 s from the
// wrapper). On timeout a CTA writes an error code into the card's error word
// and leaves; the wrapper reads the word once the launch's stream has
// synchronized and raises.
//
// What bounds it. The merge's 2 Q B D FLOP, three times on the TF32 tensor
// cores at "highest", as K3a (at the P=4 shard, 15360 x 16384 x 784: 3 x
// 3.95e11 FLOP, 2.39 ms at the 494.7 TFLOP/s dense TF32 peak), once or
// three times at the 989 TFLOP/s dense bf16 peak at "default" / "high". The block move is ~51 MB
// per hop in f32 (~154 MB with the f32 form's planes): ~0.03 (~0.09) ms of
// HBM time on one card, ~0.12 (~0.35) ms at NVLink rates, under the merge.
// K4's f32 form feeds its wgmma tile as K1/K2 do (the L2 feed that holds
// their product under half the TF32 peak); each consumer thread loads its
// 32 columns' norms and ids before its first store to the key tile, which
// keeps the loads off the key epilogue's critical path. K4's bf16/int8
// merge groups are 128 query rows, or 64 where 128-row groups would leave
// the card's resident CTA slots empty (a shard per card); K5's are 64
// rows, and its grid holds 2 CTAs per SM (launch bounds cap the registers
// at 128).

#include <cooperative_groups.h>
#include <cstring>
#include <type_traits>

// K4's f32 form runs knn_wgmma.cuh's tile with every 8-deep k-step's three
// passes promoted on their own: the interval at which its products equal
// the mma.sync Tf32x3 tile's (K3a's, K5's) bit for bit. This library is
// its own build, so K1 and K2 keep their interval.
#define KNN_WGMMA_PROMOTE 1
#include "knn_wgmma.cuh"
#include "knn_wgmma_bf16.cuh"
#include "ring_merge.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace knn;

constexpr int MAX_LOCAL = 16;  // ring ranks one card may hold in one launch
constexpr int COPY_CTAS = 8;   // CTAs (K4) or work items (K5) per block copy
constexpr int SPLIT = 8;       // K4's f32 form: copy units per COPY_CTAS part

// flag words of one rank; the card's error word is its first rank's W_ERR
enum Word {
  W_FROM_PRED = 0, W_FROM_SUCC = 1, W_LANDED = 2, W_SENT = 3, W_GO = 4,
  W_ERR = 5, G_FROM_PRED = 6, G_FROM_SUCC = 7, G_LANDED = 8, G_FREE = 9,
  W_UNITS = 10, G_UNITS = 11, NWORDS = 16
};
enum Err {
  ERR_BARRIER = 1, ERR_LANDED = 2, ERR_SENT = 3, ERR_GO = 4, ERR_FREE = 5
};

// One ring rank's operands in a launch; ops/fused_rotation.py's _Rank
// mirrors this layout.
struct Rank {
  const float* q;        // (Q, D) queries
  const int* qids;       // (Q,)
  const void* blk;       // (B, D) resident block (K5: the round-0 block)
  const float* scale;    // (B,) int8 wire only
  const int* bids;       // (B,)
  const float* carry_d;  // (Q, k) carry in
  const int* carry_i;
  float* out_d;          // (Q, k) carry out
  int* out_i;
  void* dst_blk;         // K4: successor's landing block; K5: its (2, B, D) slots
  float* dst_scale;      // K4, int8 wire: successor's landing scales
  int* dst_bids;         // K4: successor's landing ids; K5: its (2, B) slots
  int* flags;            // this rank's NWORDS words, on its card
  int* succ_flags;       // the successor's words
  int* pred_flags;       // the predecessor's words
  void* slot_blk;        // K5: own (2, B, D) slots
  int* slot_bids;        // K5: own (2, B) slots
  float* cbuf_d;         // K5: own (2, Q, k) carry ping-pong
  int* cbuf_i;
  const float* qn;       // (Q,) the queries' norms
  const float* bn;       // (B,) the resident block's norms (K5: round 0's)
  float* dst_bn;         // K4: successor's landing norms (or null: not
                         // moved); K5: its (2, B) slots
  float* slot_bn;        // K5: own (2, B) slots
  const void* qh;        // f32 wire: the queries' planes (Q, Dp): TF32 f32 at
  const void* ql;        // "highest" (K4), else bf16 (lo null at "default");
                         // K5: the staging scratch its launch writes
  const void* bh;        // f32 wire: the resident block's planes (B, Dp), as
  const void* bl;        // the queries'; K5: the staging scratch
  void* dst_bh;          // K4, f32 wire: successor's landing planes (or
  void* dst_bl;          // null: not moved)
  float* sbn;            // K5, f32 wire at "default" / "high": the resident
                         // block's norms, staged each round (B,)
  int succ_remote;       // successor on another card
  int pred_remote;       // predecessor on another card
};

struct Launch {
  Rank r[MAX_LOCAL];
  int n_local, Q, B, D, k, ring_size;
  int exclude_self, exclude_zero;
  float zero_eps;
  int epoch;             // K4: round count of the mesh; K5: call count
  long long timeout_ns;
  int* err;              // the card's error word
  int precision;         // 0 "highest", 1 "default", 2 "high"
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release_sys(int* p, int v) {
  asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void store_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int fetch_add_acq_rel_sys(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.sys.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Spin until *p >= target; false after timeout_ns.
__device__ bool wait_at_least(const int* p, int target, long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while (load_acquire_sys(p) < target) {
    if ((long long)(now_ns() - t0) > timeout_ns) return false;
    __nanosleep(256);
  }
  return true;
}

__device__ void set_err(int* err, int code) { atomicCAS(err, 0, code); }

// Share `part` of `parts` of an n-byte copy by threads t of nt: 16-byte
// vectors, four in flight a thread, where both ends are 16-byte aligned,
// single bytes for the tail (or for all of it otherwise).
template <bool CG>
__device__ void copy_part(void* dst, const void* src, size_t n, int part, int parts,
                          int t, int nt) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const size_t units = aligned ? n / 16 : 0, end = units * (part + 1) / parts;
  const int4* s4 = static_cast<const int4*>(src);
  int4* d4 = static_cast<int4*>(dst);
  size_t u = units * part / parts + t;
  for (; u + 3 * (size_t)nt < end; u += 4 * (size_t)nt) {
    const int4 a = ld<CG>(s4 + u), b = ld<CG>(s4 + u + nt), c = ld<CG>(s4 + u + 2 * nt),
               e = ld<CG>(s4 + u + 3 * nt);
    d4[u] = a;
    d4[u + nt] = b;
    d4[u + 2 * nt] = c;
    d4[u + 3 * nt] = e;
  }
  for (; u < end; u += nt) d4[u] = ld<CG>(s4 + u);
  const size_t b0 = units * 16, rest = n - b0;
  const unsigned char* sb = static_cast<const unsigned char*>(src);
  unsigned char* db = static_cast<unsigned char*>(dst);
  for (size_t b = b0 + rest * part / parts + t; b < b0 + rest * (part + 1) / parts; b += nt)
    db[b] = ld<CG>(sb + b);
}

template <int WIRE>
__host__ __device__ constexpr size_t wire_bytes() {
  return WIRE == WIRE_F32 ? 4 : WIRE == WIRE_BF16 ? 2 : 1;
}

__device__ MergeShape shape_of(const Launch& p) {
  return MergeShape{p.Q, p.B, p.D, p.k, p.exclude_self, p.exclude_zero,
                    p.zero_eps};
}

// Both barrier signals of every local rank with a remote neighbour, then
// the waits for the neighbours' signals of this epoch.
__device__ bool neighbour_barrier(const Launch& p, int w_pred, int w_succ) {
  for (int i = 0; i < p.n_local; ++i) {
    const Rank& R = p.r[i];
    if (R.pred_remote) add_release_sys(R.pred_flags + w_succ, 1);
    if (R.succ_remote) add_release_sys(R.succ_flags + w_pred, 1);
  }
  for (int i = 0; i < p.n_local; ++i) {
    const Rank& R = p.r[i];
    if (R.succ_remote && !wait_at_least(R.flags + w_succ, p.epoch, p.timeout_ns))
      return false;
    if (R.pred_remote && !wait_at_least(R.flags + w_pred, p.epoch, p.timeout_ns))
      return false;
  }
  return true;
}

// ---------------------------------------------------------------- K4

// One thread of CTA 0 (dispatched first): the neighbour barrier, the `go`
// word, then this epoch's copy-out of every local rank (SENT) and, from a
// remote predecessor, its arrival (LANDED).
__device__ void round_barrier(const Launch& p) {
  const bool ok = neighbour_barrier(p, W_FROM_PRED, W_FROM_SUCC);
  store_release_sys(p.r[0].flags + W_GO, ok ? p.epoch : -p.epoch);
  if (!ok) {
    set_err(p.err, ERR_BARRIER);
    return;
  }
  for (int i = 0; i < p.n_local; ++i) {
    const Rank& R = p.r[i];
    if (!wait_at_least(R.flags + W_SENT, p.epoch * COPY_CTAS, p.timeout_ns)) {
      set_err(p.err, ERR_SENT);
      return;
    }
    if (R.pred_remote &&
        !wait_at_least(R.flags + W_LANDED, p.epoch * COPY_CTAS, p.timeout_ns)) {
      set_err(p.err, ERR_LANDED);
      return;
    }
  }
}

// Whether the barrier thread let this epoch's copies go (one thread spins).
__device__ bool wait_go(const Launch& p) {
  const int* go = p.r[0].flags + W_GO;
  const unsigned long long t0 = now_ns();
  int v;
  while ((v = load_acquire_sys(go)) != p.epoch && v != -p.epoch) {
    if ((long long)(now_ns() - t0) > 2 * p.timeout_ns) {
      set_err(p.err, ERR_GO);
      return false;
    }
    __nanosleep(256);
  }
  return v == p.epoch;
}

// The bf16 and int8 wires: CTA 0 the barrier, COPY_CTAS copy CTAs per rank,
// then K3a's merge CTAs on the mma.sync tile.
template <int WIRE, int ROWS, class Op>
__global__ void __launch_bounds__(THREADS, 2) round_dma_kernel(Launch p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int go_ok;
  const int n_copy = p.n_local * COPY_CTAS;
  int b = blockIdx.x;

  if (b == 0) {  // the barrier CTA: dispatched first
    if (threadIdx.x == 0) round_barrier(p);
    return;
  }
  b -= 1;

  if (b < n_copy) {  // copy CTAs: the resident block to the successor
    const Rank& R = p.r[b / COPY_CTAS];
    const int part = b % COPY_CTAS;
    if (R.succ_remote) {  // its landing slot is free once it entered the round
      if (threadIdx.x == 0) go_ok = wait_go(p);
      __syncthreads();
      if (!go_ok) return;
    }
    const int t = threadIdx.x, nt = blockDim.x;
    copy_part<false>(R.dst_blk, R.blk, (size_t)p.B * p.D * wire_bytes<WIRE>(), part,
                     COPY_CTAS, t, nt);
    copy_part<false>(R.dst_bids, R.bids, (size_t)p.B * sizeof(int), part, COPY_CTAS, t, nt);
    if (WIRE == WIRE_INT8)
      copy_part<false>(R.dst_scale, R.scale, (size_t)p.B * sizeof(float), part, COPY_CTAS,
                       t, nt);
    if (R.dst_bn != nullptr)
      copy_part<false>(R.dst_bn, R.bn, (size_t)p.B * sizeof(float), part, COPY_CTAS, t,
                       nt);
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (R.succ_remote) add_release_sys(R.succ_flags + W_LANDED, 1);
      add_release_sys(R.flags + W_SENT, 1);
    }
    return;
  }
  b -= n_copy;

  const int groups = (p.Q + ROWS - 1) / ROWS;
  const Rank& R = p.r[b / groups];
  exact_merge_group<WIRE, false, ROWS, Op>(
      MergeArgs{R.q, R.qn, R.qids, R.blk, R.scale, R.bn, R.bids, R.carry_d,
                R.carry_i, R.out_d, R.out_i},
      shape_of(p), (b % groups) * ROWS, smem);
}

// The f32 wire on knn_wgmma.cuh's tile. One persistent CTA per SM walks
// the (local rank, 128-row query group) items; its producer warpgroup's
// thread 0 streams the rank's query planes and block planes by TMA, its
// two consumer warpgroups run the three wgmma passes and RoundEpi's merge.
// The transport needs no SMs of its own: it runs on the producer
// warpgroup's three spare warps (round_transport).

// exact_merge_group's merge as the consumer warpgroups' hooks: the carry
// offered first (slot j has arrival j) and NaN rows flagged, then the
// block's columns keyed by arrival k + col under RingCols' masks, then
// arrivals mapped back to the carry's ids or the block's. Each consumer
// warpgroup merges its own 64 rows (warp w of the group owns rows w, w + 4,
// ...), as ExactEpi in fused_knn.cu.
struct RoundEpi {
  const Launch* p;
  int groups, nkb, k;
  __device__ int items() const { return p->n_local * groups; }
  __device__ wg::Item item(int n) const {
    const int g = n % groups;
    return wg::Item{g * wg::ROWS, 0, p->B, (size_t)g * wg::ROWS, n / groups};
  }
  __device__ RingCols<WIRE_F32, false> cols(const Rank& R) const {
    return RingCols<WIRE_F32, false>{R.blk, nullptr, R.bids, R.qids, p->D, -k,
                                     p->exclude_self != 0, p->exclude_zero != 0,
                                     p->zero_eps, R.bn};
  }
  __device__ wg::WgLists lists(const wg::Item& t, const wg::Ctx& c) const {
    const Rank& R = p->r[t.part];
    const int r0 = 64 * c.g;
    return wg::WgLists{c.Lsd + r0 * k, c.Lsi + r0 * k, R.out_d, R.out_i, t.out_row0 + r0,
                       k};
  }
  __device__ void begin(const wg::Item& t, const wg::Ctx& c) const {
    __syncwarp();  // the previous item's emit has read the lists and flags
    const Rank& R = p->r[t.part];
    const wg::WgLists L = lists(t, c);
    const int w = c.cwarp % 4, q0 = t.q0 + 64 * c.g;
    int* nanf = c.nanf + 64 * c.g;
    init_rows<64>(L, nanf, q0, p->Q, -1, w, 4);
    __syncwarp();
    for (int r = w; r < 64; r += 4) {
      if (q0 + r >= p->Q) continue;
      const float* cd = R.carry_d + (size_t)(q0 + r) * k;
      bool any_nan = false;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + c.lane;
        any_nan |= warp_offer(L.d(r), L.i(r), k, j < k ? cd[j] : 0.f, j, j < k, c.lane);
      }
      if (any_nan && c.lane == 0) nanf[r] = 1;
      __syncwarp();
    }
  }
  // The masked keys of the chunk into the key tile, then the selection.
  // RingCols' masks, with each of the thread's 32 columns' norm and id and
  // each of its two rows' norm and id loaded once (accumulator element
  // 4 j + 2 h + b sits at row h of the two, column 8 j + 2 (lane % 4) + b),
  // through pointers held in registers: no reload of them from the
  // parameters between the key tile's stores.
  __device__ void chunk(const float (&acc)[64], const wg::Item& t, int col0,
                        const wg::Ctx& c) const {
    wg::group_sync(c.g);  // the group's warps have read its previous keys
    const Rank& R = p->r[t.part];
    const float* bn = R.bn;
    const int* bids = R.bids;
    const int Q = p->Q, w = c.cwarp % 4, r0 = 16 * w + c.lane / 4;
    const int row0 = t.q0 + 64 * c.g + r0, c_end = t.c_end;
    const bool self = p->exclude_self != 0, zero = p->exclude_zero != 0;
    const float eps = p->zero_eps;
    float qs[2];
    int qid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qs[h] = row0 + 8 * h < Q ? R.qn[row0 + 8 * h] : 0.f;
      qid[h] = row0 + 8 * h < Q ? R.qids[row0 + 8 * h] : -1;
    }
    // every load before the first store to the key tile
    float cs[32];
    int id[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = col0 + 8 * (e / 2) + 2 * (c.lane % 4) + e % 2;
      cs[e] = col < c_end ? bn[col] : 0.f;
      id[e] = col < c_end ? bids[col] : -1;
    }
    float* Ds = c.Ds + 64 * c.g * MDS;
#pragma unroll
    for (int e = 0; e < 32; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = e / 2, b = e % 2, cc = 8 * j + 2 * (c.lane % 4) + b;
        float d = __fadd_rn(__fsub_rn(qs[h], __fmul_rn(2.f, acc[4 * j + 2 * h + b])), cs[e]);
        d = d < 0.f ? 0.f : d;  // max(d, 0) that keeps NaN
        bool invalid = id[e] < 0 || row0 + 8 * h >= Q;
        if (!invalid && zero)
          invalid = d <= (eps > 0.f ? eps : __fmul_rn(1e-6f, __fadd_rn(qs[h], cs[e])));
        invalid = invalid || (self && id[e] == qid[h]);
        Ds[(r0 + 8 * h) * MDS + cc] = invalid ? inf_f() : d;
      }
    wg::group_sync(c.g);
    select_chunk<64>(cols(R), Ds, c.nanf + 64 * c.g, lists(t, c), t.q0 + 64 * c.g, Q, col0,
                     c_end, w, 4);
  }
  __device__ void end(const wg::Item& t, const wg::Ctx& c) const {
    const Rank& R = p->r[t.part];
    const wg::WgLists L = lists(t, c);
    const int w = c.cwarp % 4, q0 = t.q0 + 64 * c.g;
    for (int r = w; r < 64; r += 4) {
      const int row = q0 + r;
      if (row >= p->Q) continue;
      const float* Ld = L.d(r);
      const int* Li = L.i(r);
      float* od = R.out_d + (size_t)row * k;
      int* oi = R.out_i + (size_t)row * k;
      const bool poisoned = c.nanf[64 * c.g + r] != 0;
      for (int j = c.lane; j < k; j += 32) {
        float d = Ld[j];
        const int a = Li[j];
        int id = -1;
        if (poisoned) d = nan_f();
        else if (isfinite(d)) id = a < k ? R.carry_i[(size_t)row * k + a] : R.bids[a - k];
        od[j] = d;
        oi[j] = id;
      }
    }
  }
};

// A named barrier of the transport's copy threads (ids 1 to 3 are the
// tiles' consumer barriers).
__device__ __forceinline__ void copy_sync(int nt) {
  asm volatile("bar.sync 5, %0;" ::"r"(nt) : "memory");
}

// The pitch of the bf16 planes at "default" / "high": D rounded up to the
// bf16 tile's k-block (fused_knn.staged_width).
__host__ __device__ inline int bf16_width(int D) { return (D + wgb::KB - 1) / wgb::KB * wgb::KB; }

// Bytes of one of a block's planes: TF32 f32 at "highest", bf16 else.
__device__ inline size_t plane_bytes(const Launch& p) {
  return p.precision == 0 ? (size_t)p.B * wg::split_width(p.D) * sizeof(float)
                          : (size_t)p.B * bf16_width(p.D) * sizeof(bf16);
}

// The transport of K4's f32 form, on warp w (1..3) of the producer
// warpgroup of every CTA. In CTA 0, warp 1's first thread is the barrier
// thread (round_barrier); the other spare warps copy. Each rank's traveler
// (block, ids, norms, planes) goes to the successor's landing buffers in
// COPY_CTAS * SPLIT units, spread over the grid's CTAs: a unit is copied,
// fenced, and counted on the rank's W_UNITS word, and every SPLIT-th count
// signals SENT (and the successor's LANDED) once, so the barrier thread
// and the successor see COPY_CTAS signals per round as from the copy CTAs
// of the bf16 and int8 forms. The words only count up, so every launch
// starts at a multiple of SPLIT.
__device__ void round_transport(const Launch& p, int w) {
  __shared__ int go_ok;
  if (blockIdx.x == 0 && w == 1) {
    if (threadIdx.x % 32 == 0) round_barrier(p);
    return;
  }
  const int first = blockIdx.x == 0 ? 64 : 32;  // the copy threads' first
  const int t = threadIdx.x - first, nt = 128 - first;
  const int per_rank = COPY_CTAS * SPLIT;
  const size_t plane = plane_bytes(p);
  for (int u = blockIdx.x; u < p.n_local * per_rank; u += gridDim.x) {
    const Rank& R = p.r[u / per_rank];
    const int part = u % per_rank;
    if (R.succ_remote) {  // its landing slot is free once it entered the round
      if (t == 0) go_ok = wait_go(p);
      copy_sync(nt);
      if (!go_ok) return;
    }
    copy_part<false>(R.dst_blk, R.blk, (size_t)p.B * p.D * sizeof(float), part, per_rank,
                     t, nt);
    copy_part<false>(R.dst_bids, R.bids, (size_t)p.B * sizeof(int), part, per_rank, t, nt);
    if (R.dst_bn != nullptr)
      copy_part<false>(R.dst_bn, R.bn, (size_t)p.B * sizeof(float), part, per_rank, t, nt);
    if (R.dst_bh != nullptr) copy_part<false>(R.dst_bh, R.bh, plane, part, per_rank, t, nt);
    if (R.dst_bl != nullptr) copy_part<false>(R.dst_bl, R.bl, plane, part, per_rank, t, nt);
    __threadfence_system();
    copy_sync(nt);
    if (t == 0 && (fetch_add_acq_rel_sys(R.flags + W_UNITS, 1) + 1) % SPLIT == 0) {
      if (R.succ_remote) add_release_sys(R.succ_flags + W_LANDED, 1);
      add_release_sys(R.flags + W_SENT, 1);
    }
  }
}

// The launch's parameters: per local rank the tensor maps of its query and
// block planes, then the Launch (kernel parameters up to 32 KB: CUDA 12.1).
struct RoundWg {
  CUtensorMap maps[MAX_LOCAL][4];  // query hi, lo; block hi, lo
  Launch p;
};

__global__ void __launch_bounds__(wg::THREADS, 1)
    round_dma_kernel_wgmma(const __grid_constant__ RoundWg a) {
  // run_tile_of aligns its ring itself (wg::smem_bytes counts the slack):
  // a 1024-byte alignment here would pad every kernel of this file
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const Launch& p = a.p;
  const RoundEpi epi{&p, (p.Q + wg::ROWS - 1) / wg::ROWS, wg::split_width(p.D) / wg::KB,
                     p.k};
  wg::run_tile_of(
      [&](const wg::Item& t) {
        const CUtensorMap* m = a.maps[t.part];
        return wg::TileMaps{m, m + 1, m + 2, m + 3};
      },
      [&](int w) { round_transport(p, w); }, epi, wg_smem);
}

// The f32 wire at "default" / "high" on knn_wgmma_bf16.cuh's tile: bf16
// wgmma on P planes of the queries and of the block (P = 1: RNE(x); P = 2:
// hi and lo, the chunk's lo.hi + hi.lo passes, then its hi.hi), which K4
// reads as the traveler's fifth and sixth parts and K5 stages each round.
// RingEpi is exact_merge_group's merge as the tile's consumer hooks: the
// carry offered first (slot j has arrival j), then the block's columns
// keyed by arrival k + col (the selection runs on columns shifted by k, so
// a list entry's id is its arrival), the ids' masks (padding -1, self by
// id) and the zero rule where a key is formed or would win, and at the
// end arrivals mapped back to the carry's ids or the block's. A consumer
// warp owns 16 consecutive rows of the item, as in SweepEpi.

// The masks of a ring block's columns by id, for RingEpi (see NoMask):
// bids at the shifted columns, and the thread's rows' ids where the self
// mask holds (else -2, which no id equals).
template <bool CG>
struct RingMask {
  const int* bids;
  int qid[2];
  __device__ __forceinline__ int id(int col, int c_end) const {
    return col < c_end ? ld<CG>(bids + col) : -1;
  }
  __device__ __forceinline__ bool ok(int id, int h) const { return id >= 0 && id != qid[h]; }
  // a padding id in the chunk, or an id within the warp's rows' range
  __device__ bool any(int col0, int c_end, int lane) const {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qid[h] >= 0) {
        lo = min(lo, qid[h]);
        hi = max(hi, qid[h]);
      }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    bool hit = false;
#pragma unroll
    for (int j = 0; j < wgb::COLS / 32; ++j) {
      const int col = col0 + lane + 32 * j;
      if (col < c_end) {
        const int id = ld<CG>(bids + col);
        hit |= id < 0 || (id >= lo && id <= hi);
      }
    }
    return hit;
  }
};

// One rank's operands in a round of the bf16 forms: the block's ids and
// norms, the carry in and out.
struct RoundOps {
  const int* bids;
  const float* bn;
  const float* cd;
  const int* ci;
  float* od;
  int* oi;
};

// CG: K5 (round `round`, its slots, carry ping-pong and staged norms,
// read past L1); else K4 (the Rank's operands as they are).
template <int P, bool CG>
struct RingEpi {
  static constexpr int planes = P;
  const Launch* p;
  int groups, nkb, k, round;
  using Lists = wgb::Lists<wgb::Ring<P>::KS>;
  __device__ int items() const { return p->n_local * groups; }
  // item n: query group n % groups of local rank n / groups (in `slice`)
  __device__ wgb::Item item(int n) const {
    const int g = n % groups;
    return wgb::Item{g * wgb::ROWS, 0, p->B, g, n / groups};
  }
  __device__ RoundOps ops(const Rank& R) const {
    if constexpr (!CG) {
      return RoundOps{R.bids, R.bn, R.carry_d, R.carry_i, R.out_d, R.out_i};
    } else {
      const size_t ce = (size_t)p->Q * k, in = (size_t)((round + 1) % 2) * ce,
                   out = (size_t)(round % 2) * ce;
      const bool first = round == 0, last = round == p->ring_size - 1;
      return RoundOps{first ? R.bids : R.slot_bids + (size_t)(round % 2) * p->B, R.sbn,
                      first ? R.carry_d : R.cbuf_d + in, first ? R.carry_i : R.cbuf_i + in,
                      last ? R.out_d : R.cbuf_d + out, last ? R.out_i : R.cbuf_i + out};
    }
  }
  __device__ Lists lists(const wgb::Item& t, const wgb::Ctx& c, const RoundOps& o) const {
    return Lists::at(c.Lsd, c.Lsi, o.od, o.oi, t.q0, k);
  }
  __device__ void begin(const wgb::Item& t, const wgb::Ctx& c) const {
    const RoundOps o = ops(p->r[t.slice]);
    const Lists L = lists(t, c, o);
    const int Q = p->Q, wrow0 = 16 * c.cwarp;
    for (int r = wrow0; r < wrow0 + 16; ++r) {
      if (c.lane == 0) c.nanf[r] = c.bufn[r] = 0;
      if (t.q0 + r >= Q) continue;
      for (int j = c.lane; j < k; j += 32) { L.d(r)[j] = inf_f(); L.i(r)[j] = -1; }
    }
    __syncwarp();
    for (int r = wrow0; r < wrow0 + 16; ++r) {  // the carry: slot j has arrival j
      if (t.q0 + r >= Q) continue;
      const float* cd = o.cd + (size_t)(t.q0 + r) * k;
      bool any_nan = false;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + c.lane;
        any_nan |= warp_offer(L.d(r), L.i(r), k, j < k ? ld<CG>(cd + j) : 0.f, j, j < k,
                              c.lane);
      }
      if (any_nan && c.lane == 0) c.nanf[r] = 1;
      __syncwarp();
    }
  }
  __device__ __forceinline__ void chunk(float (&acc)[wgb::ACC], const wgb::Item& t, int col0,
                                        const float* norms, uint32_t release,
                                        const wgb::Ctx& c) const {
    const Rank& R = p->r[t.slice];
    const RoundOps o = ops(R);
    const int wrow0 = 16 * c.cwarp, r0 = t.q0 + wrow0 + c.lane / 4;
    const int row[2] = {r0, r0 + 8};
    const bool live[2] = {row[0] < p->Q, row[1] < p->Q};
    const float qs[2] = {live[0] ? R.qn[row[0]] : 0.f, live[1] ? R.qn[row[1]] : 0.f};
    const bool self = p->exclude_self != 0;
    const RingMask<CG> mask{o.bids - k, {self && live[0] ? R.qids[row[0]] : -2,
                                         self && live[1] ? R.qids[row[1]] : -2}};
    const wgb::ZeroRuleOf<CG> zero{p->zero_eps, p->exclude_zero ? o.bn - k : nullptr};
    wgb::select_regs<true>(acc, col0 + k, t.c_end + k, row, live, qs, false, norms, release,
                           lists(t, c, o), wrow0, c.nanf, c.bufn, c.cd, c.lane, zero, mask);
  }
  __device__ void end(const wgb::Item& t, const wgb::Ctx& c) const {
    const RoundOps o = ops(p->r[t.slice]);
    const Lists L = lists(t, c, o);
    const int Q = p->Q, wrow0 = 16 * c.cwarp;
    // the winners still buffered into their lists
    const unsigned rows = __ballot_sync(
        FULL, c.lane < 16 && t.q0 + wrow0 + c.lane < Q && c.bufn[wrow0 + (c.lane & 15)] > 0);
    wgb::flush_rows(rows, L, wrow0, c.bufn, c.cd, c.lane);
    for (int r = wrow0; r < wrow0 + 16; ++r) {  // arrivals become ids
      const int row = t.q0 + r;
      if (row >= Q) continue;
      const bool poisoned = c.nanf[r] != 0;
      float* od = o.od + (size_t)row * k;
      int* oi = o.oi + (size_t)row * k;
      for (int j = c.lane; j < k; j += 32) {
        float d = L.d(r)[j];
        const int a = L.i(r)[j];
        int id = -1;
        if (poisoned) d = nan_f();
        else if (isfinite(d)) id = a < k ? ld<CG>(o.ci + (size_t)row * k + a) : ld<CG>(o.bids + (a - k));
        od[j] = d;
        oi[j] = id;
      }
    }
  }
};

// The bf16 forms' launch parameters: per local rank the tensor maps of its
// query planes hi, lo, its block planes hi, lo and the block norms, then
// the Launch.
struct RingWgb {
  CUtensorMap maps[MAX_LOCAL][5];
  Launch p;
};

__device__ __forceinline__ wgb::TileMaps maps_of(const RingWgb& a, int rank) {
  const CUtensorMap* m = a.maps[rank];
  return wgb::TileMaps{m, m + 2, m + 1, m + 3, m + 4};
}

// K4 at "default" (P = 1) / "high" (P = 2) on the f32 wire: one persistent
// CTA per SM over the (local rank, 128-row query group) items, the traveler
// moved by round_transport on the producer's spare warps, as the TF32 form.
template <int P>
__global__ void __launch_bounds__(wgb::THREADS, 1)
    round_dma_kernel_bf16(const __grid_constant__ RingWgb a) {
  extern __shared__ __align__(16) unsigned char wgb_smem[];
  const Launch& p = a.p;
  const RingEpi<P, false> epi{&p, (p.Q + wgb::ROWS - 1) / wgb::ROWS, bf16_width(p.D) / wgb::KB,
                              p.k, 0};
  wgb::init_ring<P>(wgb_smem);
  uint32_t it = 0;
  wgb::walk_tile<true>([&](const wgb::Item& t) { return maps_of(a, t.slice); },
                       [&](int w) { round_transport(p, w); }, epi, wgb_smem, it);
}

// ---------------------------------------------------------------- K5

template <int WIRE, int ROWS, class Op>
__global__ void __launch_bounds__(THREADS, 2) rotation_grid_kernel(Launch p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int stop;
  cg::grid_group grid = cg::this_grid();
  const int P = p.ring_size, G = p.epoch;
  const int groups = (p.Q + ROWS - 1) / ROWS;
  const int n_merge = p.n_local * groups;
  const size_t blk_bytes = (size_t)p.B * p.D * wire_bytes<WIRE>();
  const size_t carry_elems = (size_t)p.Q * p.k;
  const int frees = P > 2 ? P - 2 : 0;  // releases per call

  for (int r = 0; r < P; ++r) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      int err = 0;
      if (r == 0 && !neighbour_barrier(p, G_FROM_PRED, G_FROM_SUCC))
        err = ERR_BARRIER;
      for (int i = 0; i < p.n_local && !err; ++i) {
        const Rank& R = p.r[i];
        // the successor's slot (r+1)%2 is free: consume its r-th release
        if (r >= 1 && r <= P - 2 && R.succ_remote &&
            !wait_at_least(R.flags + G_FREE, (G - 1) * frees + r, p.timeout_ns))
          err = ERR_FREE;
        // the predecessor's round r-1 stream has landed in slot r%2
        else if (r >= 1 && R.pred_remote &&
                 !wait_at_least(R.flags + G_LANDED,
                                ((G - 1) * (P - 1) + r) * COPY_CTAS, p.timeout_ns))
          err = ERR_LANDED;
      }
      if (err) set_err(p.err, err);
    }
    grid.sync();
    if (threadIdx.x == 0) stop = load_acquire_sys(p.err) != 0;
    __syncthreads();
    if (stop) return;  // every CTA leaves at the same round

    const bool stream = r < P - 1;
    const int n_items = n_merge + (stream ? p.n_local * COPY_CTAS : 0);
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      if (it < n_merge) {
        const Rank& R = p.r[it / groups];
        const size_t cin = (size_t)((r + 1) % 2) * carry_elems;
        const size_t cout = (size_t)(r % 2) * carry_elems;
        MergeArgs m{
            R.q, R.qn, R.qids,
            r == 0 ? R.blk
                   : static_cast<const unsigned char*>(R.slot_blk) + (r % 2) * blk_bytes,
            nullptr,
            r == 0 ? R.bn : R.slot_bn + (size_t)(r % 2) * p.B,
            r == 0 ? R.bids : R.slot_bids + (size_t)(r % 2) * p.B,
            r == 0 ? R.carry_d : R.cbuf_d + cin,
            r == 0 ? R.carry_i : R.cbuf_i + cin,
            r == P - 1 ? R.out_d : R.cbuf_d + cout,
            r == P - 1 ? R.out_i : R.cbuf_i + cout};
        exact_merge_group<WIRE, true, ROWS, Op>(m, shape_of(p), (it % groups) * ROWS, smem);
      } else {
        const int c = it - n_merge;
        const Rank& R = p.r[c / COPY_CTAS];
        const int part = c % COPY_CTAS;
        const void* src =
            r == 0 ? R.blk
                   : static_cast<const unsigned char*>(R.slot_blk) + (r % 2) * blk_bytes;
        const int* sid = r == 0 ? R.bids : R.slot_bids + (size_t)(r % 2) * p.B;
        const float* sbn = r == 0 ? R.bn : R.slot_bn + (size_t)(r % 2) * p.B;
        const int nxt = (r + 1) % 2;
        const int t = threadIdx.x, nt = blockDim.x;
        copy_part<true>(static_cast<unsigned char*>(R.dst_blk) + nxt * blk_bytes,
                        src, blk_bytes, part, COPY_CTAS, t, nt);
        copy_part<true>(R.dst_bids + (size_t)nxt * p.B, sid,
                        (size_t)p.B * sizeof(int), part, COPY_CTAS, t, nt);
        copy_part<true>(R.dst_bn + (size_t)nxt * p.B, sbn,
                        (size_t)p.B * sizeof(float), part, COPY_CTAS, t, nt);
        __threadfence_system();
        __syncthreads();
        if (threadIdx.x == 0 && R.succ_remote)
          add_release_sys(R.succ_flags + G_LANDED, 1);
      }
    }
    grid.sync();  // round r's reads of slot r%2 and its stream are retired
    if (blockIdx.x == 0 && threadIdx.x == 0 && r < P - 2)
      for (int i = 0; i < p.n_local; ++i)
        if (p.r[i].pred_remote) add_release_sys(p.r[i].pred_flags + G_FREE, 1);
  }
}

// K5's block move of round r on the f32 wire at "default" / "high", on
// warp w (1..3) of the producer warpgroup of every CTA while the tile
// merges: each rank's resident block, ids and norms (round 0 the caller's,
// then slot r % 2) into the successor's slot (r + 1) % 2, in COPY_CTAS *
// SPLIT units spread over the grid. A unit is copied, fenced and, where the
// successor is remote, counted on the rank's G_UNITS word; every SPLIT-th
// count adds one to the successor's G_LANDED, so it sees COPY_CTAS landed
// adds a hop, as from rotation_grid_kernel's copy items (the words only
// count up: every launch starts at a multiple of SPLIT).
__device__ void rotation_transport(const Launch& p, int r) {
  const int t = threadIdx.x - 32, nt = 96;
  const int per_rank = COPY_CTAS * SPLIT, cur = r % 2, nxt = (r + 1) % 2;
  const size_t blk_bytes = (size_t)p.B * p.D * sizeof(float);
  for (int u = blockIdx.x; u < p.n_local * per_rank; u += gridDim.x) {
    const Rank& R = p.r[u / per_rank];
    const int part = u % per_rank;
    const void* src =
        r == 0 ? R.blk : static_cast<const unsigned char*>(R.slot_blk) + cur * blk_bytes;
    const int* sid = r == 0 ? R.bids : R.slot_bids + (size_t)cur * p.B;
    const float* sbn = r == 0 ? R.bn : R.slot_bn + (size_t)cur * p.B;
    copy_part<true>(static_cast<unsigned char*>(R.dst_blk) + nxt * blk_bytes, src, blk_bytes,
                    part, per_rank, t, nt);
    copy_part<true>(R.dst_bids + (size_t)nxt * p.B, sid, (size_t)p.B * sizeof(int), part,
                    per_rank, t, nt);
    copy_part<true>(R.dst_bn + (size_t)nxt * p.B, sbn, (size_t)p.B * sizeof(float), part,
                    per_rank, t, nt);
    __threadfence_system();
    copy_sync(nt);
    if (t == 0 && R.succ_remote &&
        (fetch_add_acq_rel_sys(R.flags + G_UNITS, 1) + 1) % SPLIT == 0)
      add_release_sys(R.succ_flags + G_LANDED, 1);
  }
}

// K5's staging of round r at "default" / "high", by every thread of the
// grid: each rank's resident block's planes (RNE hi, and with two planes
// lo, as fused_knn's stage_planes) and norms into its scratch on this
// card, and in round 0 its queries' planes. The tile's TMA reads them
// after the grid sync; the stores are ordered before those reads (async
// proxy) by the fence that follows them.
template <int P>
__device__ void stage_round(const Launch& p, int r) {
  const int Dp = bf16_width(p.D), per_row = Dp / 8;
  const size_t blk_bytes = (size_t)p.B * p.D * sizeof(float);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  for (int i = 0; i < p.n_local; ++i) {
    const Rank& R = p.r[i];
    const float* src = static_cast<const float*>(
        r == 0 ? R.blk
               : static_cast<const unsigned char*>(R.slot_blk) + (r % 2) * blk_bytes);
    bf16* hi = static_cast<bf16*>(const_cast<void*>(R.bh));
    bf16* lo = P == 2 ? static_cast<bf16*>(const_cast<void*>(R.bl)) : nullptr;
    for (long long n = tid; n < (long long)p.B * per_row; n += nt) {
      const int row = (int)(n / per_row), d0 = (int)(n % per_row) * 8;
      wgb::stage_planes8<true>(src + (size_t)row * p.D, p.D, d0, hi, lo, (size_t)row * Dp + d0);
    }
    const float* bn = r == 0 ? R.bn : R.slot_bn + (size_t)(r % 2) * p.B;
    for (long long n = tid; n < p.B; n += nt) R.sbn[n] = __ldcg(bn + n);
    if (r > 0) continue;
    bf16* qh = static_cast<bf16*>(const_cast<void*>(R.qh));
    bf16* ql = P == 2 ? static_cast<bf16*>(const_cast<void*>(R.ql)) : nullptr;
    for (long long n = tid; n < (long long)p.Q * per_row; n += nt) {
      const int row = (int)(n / per_row), d0 = (int)(n % per_row) * 8;
      wgb::stage_planes8<false>(R.q + (size_t)row * p.D, p.D, d0, qh, ql, (size_t)row * Dp + d0);
    }
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// K5 at "default" (P = 1) / "high" (P = 2) on the f32 wire: the schedule
// of rotation_grid_kernel (its waits, grid syncs, slot releases, carry
// ping-pong and L1-bypassing reads of the slots), one CTA per SM, each
// round's merges on the bf16 tile with RingEpi over the planes this
// launch stages into the ranks' scratch (stage_round, then a grid sync),
// and the block's move on the producer's spare warps (rotation_transport).
// The slots, and what crosses to another card or process, stay the f32
// block, its ids and norms: the planes are made on each card.
template <int P>
__global__ void __launch_bounds__(wgb::THREADS, 1)
    rotation_grid_kernel_bf16(const __grid_constant__ RingWgb a) {
  extern __shared__ __align__(16) unsigned char wgb_smem[];
  __shared__ int stop;
  cg::grid_group grid = cg::this_grid();
  const Launch& p = a.p;
  const int Pr = p.ring_size, G = p.epoch;
  const int frees = Pr > 2 ? Pr - 2 : 0;  // releases per call
  wgb::init_ring<P>(wgb_smem);
  uint32_t it = 0;
  for (int r = 0; r < Pr; ++r) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      int err = 0;
      if (r == 0 && !neighbour_barrier(p, G_FROM_PRED, G_FROM_SUCC))
        err = ERR_BARRIER;
      for (int i = 0; i < p.n_local && !err; ++i) {
        const Rank& R = p.r[i];
        // the successor's slot (r+1)%2 is free: consume its r-th release
        if (r >= 1 && r <= Pr - 2 && R.succ_remote &&
            !wait_at_least(R.flags + G_FREE, (G - 1) * frees + r, p.timeout_ns))
          err = ERR_FREE;
        // the predecessor's round r-1 stream has landed in slot r%2
        else if (r >= 1 && R.pred_remote &&
                 !wait_at_least(R.flags + G_LANDED,
                                ((G - 1) * (Pr - 1) + r) * COPY_CTAS, p.timeout_ns))
          err = ERR_LANDED;
      }
      if (err) set_err(p.err, err);
    }
    grid.sync();
    if (threadIdx.x == 0) stop = load_acquire_sys(p.err) != 0;
    __syncthreads();
    if (stop) return;  // every CTA leaves at the same round
    stage_round<P>(p, r);
    grid.sync();  // the scratch is staged; the copy-out may start
    asm volatile("fence.proxy.async.global;" ::: "memory");
    const RingEpi<P, true> epi{&p, (p.Q + wgb::ROWS - 1) / wgb::ROWS,
                               bf16_width(p.D) / wgb::KB, p.k, r};
    wgb::walk_tile<false>([&](const wgb::Item& t) { return maps_of(a, t.slice); },
                          [&](int) {
                            if (r < Pr - 1) rotation_transport(p, r);
                          },
                          epi, wgb_smem, it);
    grid.sync();  // round r's reads of slot r%2 and its stream are retired
    if (blockIdx.x == 0 && threadIdx.x == 0 && r < Pr - 2)
      for (int i = 0; i < p.n_local; ++i)
        if (p.r[i].pred_remote) add_release_sys(p.r[i].pred_flags + G_FREE, 1);
  }
}

bool bad_launch(const Launch& p) {
  if (p.n_local < 1 || p.n_local > MAX_LOCAL || p.Q <= 0 || p.B <= 0 ||
      p.D <= 0 || p.k <= 0 || p.ring_size < 1 || p.epoch < 1 ||
      p.err == nullptr)
    return true;
  for (int i = 0; i < p.n_local; ++i) {
    const Rank& R = p.r[i];
    if (!R.q || !R.qn || !R.qids || !R.blk || !R.bn || !R.bids || !R.carry_d ||
        !R.carry_i || !R.out_d || !R.out_i || !R.dst_blk || !R.dst_bids || !R.flags ||
        ((R.succ_remote || R.pred_remote) && (!R.succ_flags || !R.pred_flags)))
      return true;
  }
  return false;
}

Launch make_launch(const void* ranks_v, int n_local, int Q, int B, int D, int k,
                   int ring_size, int exclude_self, int exclude_zero,
                   float zero_eps, int epoch, long long timeout_ns, int* err,
                   int precision) {
  const Rank* ranks = static_cast<const Rank*>(ranks_v);
  Launch p{};
  for (int i = 0; i < n_local && i < MAX_LOCAL; ++i) p.r[i] = ranks[i];
  p.n_local = n_local;
  p.Q = Q; p.B = B; p.D = D; p.k = k;
  p.ring_size = ring_size;
  p.exclude_self = exclude_self;
  p.exclude_zero = exclude_zero;
  p.zero_eps = zero_eps;
  p.epoch = epoch;
  p.timeout_ns = timeout_ns;
  p.err = err;
  p.precision = precision;
  return p;
}

template <int WIRE, class Op>
const void* round_kernel(int rows) {
  return rows == MQB ? (const void*)round_dma_kernel<WIRE, MQB, Op>
                     : (const void*)round_dma_kernel<WIRE, NQB, Op>;
}

// K5's merge items are 64-row groups: on top of the 128-row tile, the
// cooperative kernel's own state spills 424 bytes a thread (88 at 64 rows)
template <int WIRE, class Op>
const void* grid_kernel() {
  return (const void*)rotation_grid_kernel<WIRE, NQB, Op>;
}

#ifndef RING_MMA_SYNC_BASELINE
// The bf16 tile's forms on the f32 wire: K4 (which 0) or K5 (1) at
// precision 1 ("default": one plane) or 2 ("high": two).
const void* bf16_kernel(int which, int precision) {
  if (which == 0)
    return precision == 1 ? (const void*)round_dma_kernel_bf16<1>
                          : (const void*)round_dma_kernel_bf16<2>;
  return precision == 1 ? (const void*)rotation_grid_kernel_bf16<1>
                        : (const void*)rotation_grid_kernel_bf16<2>;
}
#endif

// which: 0 K4, 1 K5 (float wires only); precision 0 "highest", 1
// "default", 2 "high". On the f32 wire K4 runs the TF32 wgmma tile at
// "highest" and K4 and K5 the bf16 one at "default" / "high"; the other
// forms run knn_tile.cuh's mma.sync tile. A build with
// RING_MMA_SYNC_BASELINE (a measurement build, which no wrapper loads)
// runs the f32 wire at "default" / "high" on the mma.sync kernels as
// before the bf16 forms.
const void* kernel_of(int which, int wire, int rows, int precision) {
  if (precision < 0 || precision > 2) return nullptr;
  if (which == 0 && wire == WIRE_F32 && precision == 0)
    return (const void*)round_dma_kernel_wgmma;
#ifndef RING_MMA_SYNC_BASELINE
  if (wire == WIRE_F32 && precision > 0 && (which == 0 || which == 1))
    return bf16_kernel(which, precision);
#endif
  return with_precision(precision, [&](auto op) -> const void* {
    using Op = decltype(op);
    constexpr bool tf32 = std::is_same_v<Op, Tf32x3>;
    if (which == 0) {
      switch (wire) {
        case WIRE_F32:
#ifdef RING_MMA_SYNC_BASELINE
          if constexpr (!tf32) return round_kernel<WIRE_F32, Op>(rows);
#endif
          return nullptr;
        case WIRE_BF16: return round_kernel<WIRE_BF16, Op>(rows);
        case WIRE_INT8: return round_kernel<WIRE_INT8, Op>(rows);
      }
    } else if (which == 1) {
      switch (wire) {
        case WIRE_F32:
#ifndef RING_MMA_SYNC_BASELINE
          if constexpr (!tf32) return nullptr;
#endif
          return grid_kernel<WIRE_F32, Op>();
        case WIRE_BF16: return grid_kernel<WIRE_BF16, Op>();
      }
    }
    return nullptr;
  });
}

// A launch's plan on the current card: query rows per merge group (the
// wgmma forms: 128; K4's other forms 128, or 64 where the card's resident
// slots would go half empty; K5's mma.sync forms: 64), the grid (the wgmma
// forms and K5: persistent CTAs, the bf16 forms one per SM; K4's other
// forms: barrier + copy + merge CTAs), the items a round (merge items, and
// copy items where CTAs or work items take them), the copy units a round,
// whether the tile is a wgmma one (K4's f32 form at every precision, K5's
// at "default" / "high"), and the kernel's registers, spilled bytes and
// CTAs per SM.
struct Plan {
  int rows, grid, items, regs, local_bytes, ctas_per_sm, copy_units, wgmma;
  const void* kernel;
  size_t smem;
};

cudaError_t wgmma_plan(int n_local, int Q, int k, Plan* pl) {
  pl->kernel = (const void*)round_dma_kernel_wgmma;
  pl->rows = wg::ROWS;
  pl->items = n_local * ((Q + wg::ROWS - 1) / wg::ROWS);
  pl->copy_units = n_local * COPY_CTAS * SPLIT;
  pl->wgmma = 1;
  pl->smem = wg::smem_bytes(k);
  cudaFuncAttributes attr;
  cudaError_t e = wg::tile_grid(pl->kernel, k, pl->items, &pl->grid, &pl->ctas_per_sm);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, pl->kernel);
  if (e != cudaSuccess) return e;
  pl->regs = attr.numRegs;
  pl->local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

#ifndef RING_MMA_SYNC_BASELINE
// The bf16 forms: a CTA on every SM, whatever the items (K5: a cooperative
// grid, all of whose CTAs stage each round; K4: its copy units run on every
// CTA's spare warps, so a round of few items, a serving batch's, still
// moves the traveler at the card's rate and not at a few SMs').
cudaError_t bf16_plan(int which, int precision, int n_local, int Q, int k, Plan* pl) {
  pl->kernel = bf16_kernel(which, precision);
  pl->rows = wgb::ROWS;
  pl->items = n_local * ((Q + wgb::ROWS - 1) / wgb::ROWS);
  pl->copy_units = n_local * COPY_CTAS * SPLIT;
  pl->wgmma = 1;
  const bool two = precision == 2;
  pl->smem = two ? wgb::smem_bytes<2>(k) : wgb::smem_bytes<1>(k);
  cudaError_t e = two ? wgb::tile_grid<2>(pl->kernel, k, LLONG_MAX, &pl->grid, &pl->ctas_per_sm)
                      : wgb::tile_grid<1>(pl->kernel, k, LLONG_MAX, &pl->grid, &pl->ctas_per_sm);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, pl->kernel);
  if (e != cudaSuccess) return e;
  pl->regs = attr.numRegs;
  pl->local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}
#endif

cudaError_t plan_of(int which, int wire, int precision, int n_local, int Q, int k,
                    Plan* pl) {
  const void* k128 = kernel_of(which, wire, MQB, precision);
  if (k128 == nullptr || n_local < 1 || Q <= 0 || k <= 0) return cudaErrorInvalidValue;
  if (k128 == (const void*)round_dma_kernel_wgmma) return wgmma_plan(n_local, Q, k, pl);
#ifndef RING_MMA_SYNC_BASELINE
  if (wire == WIRE_F32 && precision > 0) return bf16_plan(which, precision, n_local, Q, k, pl);
#endif
  cudaError_t e = cudaSuccess;
  if (which == 1)
    pl->rows = NQB;  // see grid_kernel
  else
    e = pick_rows(k128, k, (long long)n_local * ((Q + MQB - 1) / MQB), &pl->rows);
  if (e != cudaSuccess) return e;
  pl->kernel = kernel_of(which, wire, pl->rows, precision);
  e = pl->rows == MQB
          ? mma_kernel_info<MQB>(pl->kernel, k, &pl->regs, &pl->local_bytes,
                                 &pl->ctas_per_sm)
          : mma_kernel_info<NQB>(pl->kernel, k, &pl->regs, &pl->local_bytes,
                                 &pl->ctas_per_sm);
  if (e != cudaSuccess) return e;
  pl->smem = pl->rows == MQB ? mma_smem_bytes<MQB>(k) : mma_smem_bytes<NQB>(k);
  const int groups = (Q + pl->rows - 1) / pl->rows;
  pl->items = n_local * (groups + COPY_CTAS);
  pl->copy_units = n_local * COPY_CTAS;
  pl->wgmma = 0;
  if (which == 0) {
    pl->grid = 1 + pl->items;
    return cudaSuccess;
  }
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if (pl->ctas_per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  pl->grid = pl->ctas_per_sm * sms < pl->items ? pl->ctas_per_sm * sms : pl->items;
  return cudaSuccess;
}

// K4's f32 form: the tensor maps of every local rank's query and block
// planes (pitch split_width(D)), then the persistent grid.
cudaError_t launch_wgmma(const Launch& p, const Plan& pl, cudaStream_t stream) {
  static_assert(sizeof(RoundWg) <= 32764, "kernel parameters past 32 KB");
  RoundWg a;  // ~12 KB, copied by the launch
  const int Dp = wg::split_width(p.D);
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < p.n_local && e == cudaSuccess; ++i) {
    const Rank& R = p.r[i];
    if (!R.qh || !R.ql || !R.bh || !R.bl) return cudaErrorInvalidValue;
    const auto f32 = [](const void* x) { return static_cast<const float*>(x); };
    e = wg::plane_map(&a.maps[i][0], f32(R.qh), p.Q, Dp);
    if (e == cudaSuccess) e = wg::plane_map(&a.maps[i][1], f32(R.ql), p.Q, Dp);
    if (e == cudaSuccess) e = wg::plane_map(&a.maps[i][2], f32(R.bh), p.B, Dp);
    if (e == cudaSuccess) e = wg::plane_map(&a.maps[i][3], f32(R.bl), p.B, Dp);
  }
  if (e != cudaSuccess) return e;
  a.p = p;
  void* args[] = {&a};
  return cudaLaunchKernel(pl.kernel, dim3(pl.grid), dim3(wg::THREADS), args, pl.smem, stream);
}

// The bf16 forms: per local rank the maps of its query and block planes
// (pitch bf16_width(D); lo at "high" only) and of its block norms (K4: the
// traveler's, 16-byte aligned as TMA reads them; K5: the staged ones),
// then K4's persistent grid or K5's cooperative one.
cudaError_t launch_bf16(int which, const Launch& p, const Plan& pl, cudaStream_t stream) {
  static_assert(sizeof(RingWgb) <= 32764, "kernel parameters past 32 KB");
  RingWgb a;  // ~15 KB, copied by the launch
  const int Dp = bf16_width(p.D);
  const bool two = p.precision == 2;
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < p.n_local && e == cudaSuccess; ++i) {
    const Rank& R = p.r[i];
    const float* bn = which == 0 ? R.bn : R.sbn;
    if (!R.qh || !R.bh || !bn || (two && (!R.ql || !R.bl))) return cudaErrorInvalidValue;
    e = wgb::bf16_map(&a.maps[i][0], R.qh, p.Q, Dp, wgb::ROWS);
    if (e == cudaSuccess && two) e = wgb::bf16_map(&a.maps[i][1], R.ql, p.Q, Dp, wgb::ROWS);
    if (e == cudaSuccess) e = wgb::bf16_map(&a.maps[i][2], R.bh, p.B, Dp, wgb::COLS);
    if (e == cudaSuccess && two) e = wgb::bf16_map(&a.maps[i][3], R.bl, p.B, Dp, wgb::COLS);
    if (e == cudaSuccess) e = wgb::norms_map(&a.maps[i][4], bn, p.B);
  }
  if (e != cudaSuccess) return e;
  a.p = p;
  void* args[] = {&a};
  return which == 0 ? cudaLaunchKernel(pl.kernel, dim3(pl.grid), dim3(wgb::THREADS), args,
                                       pl.smem, stream)
                    : cudaLaunchCooperativeKernel(pl.kernel, dim3(pl.grid),
                                                  dim3(wgb::THREADS), args, pl.smem, stream);
}

cudaError_t launch(int which, int wire, Launch p, cudaStream_t stream) {
  Plan pl;
  cudaError_t e = plan_of(which, wire, p.precision, p.n_local, p.Q, p.k, &pl);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = pl.wgmma ? (p.precision == 0 ? launch_wgmma(p, pl, stream) : launch_bf16(which, p, pl, stream))
      : which == 0
          ? cudaLaunchKernel(pl.kernel, dim3(pl.grid), dim3(THREADS), args, pl.smem, stream)
          : cudaLaunchCooperativeKernel(pl.kernel, dim3(pl.grid), dim3(THREADS), args,
                                        pl.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ring_max_local() { return MAX_LOCAL; }
// The protocol the host side restates (ops/fused_rotation.py's PROTOCOL),
// for it to check at load: COPY_CTAS and the flag words it reads or writes.
int ring_protocol(int* out) {
  const int p[] = {COPY_CTAS, NWORDS, W_ERR, G_FROM_PRED, G_FROM_SUCC,
                   G_LANDED, G_FREE};
  for (int i = 0; i < 7; ++i) out[i] = p[i];
  return 7;
}
int ring_rank_bytes() { return (int)sizeof(Rank); }

// Peer access from card `dev` to card `peer`; "already enabled" counts as
// success. The calling thread's current card is left as it was.
int ring_enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

// CUDA IPC for the grid form across the processes of one host
// (parallel/ipc.py): memory of its own on card `dev` (one cudaMalloc, so a
// handle names exactly it), its handle, and the mapping of another
// process's handle into card `dev` (peer access to the exporter's card
// enabled lazily where it is another card). The calling thread's current
// card is left as it was.
int ring_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

int ring_ipc_alloc(int dev, long long bytes, void** out) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(dev)) == cudaSuccess) e = cudaMalloc(out, (size_t)bytes);
  cudaSetDevice(prev);
  return (int)e;
}

int ring_ipc_free(int dev, void* p) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(dev)) == cudaSuccess) e = cudaFree(p);
  cudaSetDevice(prev);
  return (int)e;
}

int ring_ipc_handle(void* p, unsigned char* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, p);
  if (e == cudaSuccess) memcpy(out, &h, sizeof h);
  return (int)e;
}

int ring_ipc_open(int dev, const unsigned char* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(dev)) == cudaSuccess)
    e = cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  cudaSetDevice(prev);
  return (int)e;
}

int ring_ipc_close(int dev, void* p) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(dev)) == cudaSuccess) e = cudaIpcCloseMemHandle(p);
  cudaSetDevice(prev);
  return (int)e;
}

// K4: one round for the card's local ranks (`ranks`: n_local Rank structs).
// wire: 0 f32, 1 bf16, 2 int8 codes with (B,) f32 scales; precision: 0
// "highest", 1 "default", 2 "high".
int round_dma_launch(const void* ranks, int n_local, int Q, int B, int D,
                     int k, int wire, int ring_size, int exclude_self,
                     int exclude_zero, float zero_eps, int epoch,
                     long long timeout_ns, int* err, int precision,
                     cudaStream_t stream) {
  Launch p = make_launch(ranks, n_local, Q, B, D, k, ring_size, exclude_self,
                         exclude_zero, zero_eps, epoch, timeout_ns, err, precision);
  if (bad_launch(p)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_local; ++i)
    if (wire == WIRE_INT8 && (!p.r[i].scale || !p.r[i].dst_scale))
      return (int)cudaErrorInvalidValue;
  return (int)launch(0, wire, p, stream);
}

// K5: the whole rotation for the card's local ranks; float wires only.
int rotation_grid_launch(const void* ranks, int n_local, int Q, int B, int D,
                         int k, int wire, int ring_size, int exclude_self,
                         int exclude_zero, float zero_eps, int epoch,
                         long long timeout_ns, int* err, int precision,
                         cudaStream_t stream) {
  Launch p = make_launch(ranks, n_local, Q, B, D, k, ring_size, exclude_self,
                         exclude_zero, zero_eps, epoch, timeout_ns, err, precision);
  if (bad_launch(p)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_local; ++i)
    if (!p.r[i].slot_blk || !p.r[i].slot_bids || !p.r[i].slot_bn ||
        !p.r[i].dst_bn || !p.r[i].cbuf_d || !p.r[i].cbuf_i)
      return (int)cudaErrorInvalidValue;
  return (int)launch(1, wire, p, stream);
}

// The plan of a K4 (which 0) or K5 (which 1) launch of n_local ranks on the
// current card: out[0..9) = query rows per merge group, grid, items per
// round (merge items, plus copy items where CTAs or work items take them),
// registers, spilled bytes a thread, CTAs per SM, copy units per round,
// 1 where the tile is a wgmma one (the f32 wire's forms but K5's at
// "highest"), and the dynamic shared bytes a CTA (out[8]).
int ring_kernel_plan(int which, int wire, int precision, int n_local, int Q, int k,
                     int* out) {
  Plan pl;
  cudaError_t e = plan_of(which, wire, precision, n_local, Q, k, &pl);
  if (e != cudaSuccess) return (int)e;
  const int vals[9] = {pl.rows, pl.grid, pl.items, pl.regs, pl.local_bytes,
                       pl.ctas_per_sm, pl.copy_units, pl.wgmma, (int)pl.smem};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// K4's prologue on the f32 wire: x (N, D) f32 -> the planes hi, lo (N, Dp)
// f32 and norms (N,) f32, the diagonal of K4's own tile at its promotion
// interval; Dp = D rounded up to 16.
int round_stage_split_launch(const float* x, float* hi, float* lo, float* norms, int N,
                             int D, int Dp, cudaStream_t stream) {
  return (int)wg::stage_split(F32Rows{x, D}, N, D, Dp, hi, lo, norms, stream);
}

}  // extern "C"

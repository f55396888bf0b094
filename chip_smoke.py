#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mpi_knn_tpu_torch).

    python3 chip_smoke.py        # needs one CUDA card; builds csrc/ with nvcc

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel source compiles with nvcc, all started together;
3. kernel vs plain: each kernel mode against its plain PyTorch version on
   the same card inputs. The fused kNN kernels (K1 tiles, K2 sweep), exact
   and compress: small-integer data (every product exact in f32 and every
   value exact in bf16: ids and distances must be equal), MNIST-shaped
   8192x784 all-pairs, a query-mode case with a ragged corpus and the main
   path's 60000x784 shape. The ring block merge (K3a exact, K3b compress):
   small-integer cases on f32, bf16 and int8 wires with rotated ids,
   padding, a duplicate, a self id and a carry that ties block entries
   (bitwise), then the ring's P=1 MNIST shape (60416 queries, a 61440-row
   block) and a P=4 shard shape (15360 queries, a 16384-row block, a
   carry from the rank's own block). The ring transport (K4 one round,
   K5 the whole rotation) on the 4-rank mesh: small-integer cases at P=1
   (the block copied to itself) and P=4 on f32 and bf16 (K4 also int8),
   bitwise, with every rank's landing buffers equal to its predecessor's
   block; then K4 at the P=1 shape and one P=4 round (round 1: the own
   blocks merged, the blocks one rank on), and K5 over the P=4 rotation.
   Off the small-integer cases every id
   is judged by its own f64 key from the inputs (the squared distance, or
   in compress mode q^2 - 2 bf16(q).bf16(c) + c^2): -1 exactly on
   non-finite slots, never the row itself, no id twice in a list, inside
   its list's range; keys within rtol 1e-5 + 1e-4*(q^2+c^2) of the plain
   version's and of the id's own; ids agree at >= 0.999, an id the plain
   version did not pick counting when its own key ties the plain k-th.
   Each mode and its plain version are timed by CUDA events at the main
   shapes (across cards by the host clock between synchronizations; K4
   and K5, whose wrappers synchronize after each launch, by the
   profiler's device time per launch, their per-call time beside it),
   beside one yardstick each on the same card inputs: the serial backend,
   the ring's xla-form round, for K4 K3a plus the block's Tensor.copy_ on
   the launch's ranks, for K5 the driver-transport rotation with K3a.
   Then
   planted duplicates (an exact pair, a near-twin at d^2 = 64) go through
   every mixed path on the card (the rerank must drop the pair and keep
   the twin first at 64) and every exact path (pallas tiles and sweep,
   ring P=1, P=4 bidir, fused-dma, fused-grid, resume: the tile itself
   must drop the pair);
4. main paths, at full width (60000x784, k=10), each driven with the
   launch counts set to 0 just before it and read just after, then the
   median of 3 synchronised all-kNN reps (host input, then device input;
   warm-up excluded), and recall@10 against an f64 host oracle on 256 rows
   (>= 0.999 or fail):
   - KNNClassifier(backend="pallas"), exact and mixed, tiles and sweep;
   - the serial backend;
   - KNNClassifier(backend="ring-overlap", ring_fusion="fused",
     num_devices=1): exact, mixed, and mixed with the int8 wire;
   - all_knn on a 4-rank mesh (4 cards when the machine has them, else one
     card named 4 times): fused exact uni (K4: rounds x cards launches)
     and bidir (16 K3a launches), and one xla-form run;
   - the transport on that mesh: fused-dma (K4 each round, 4 x cards
     launches) and fused-grid (K5, one launch per card); each must equal,
     bit for bit, the driver-transport K3a ring on the same inputs;
   - resume: all_knn_ring_resumable on that mesh, stopped after 2 of 4
     rounds into a temporary checkpoint directory and resumed; it must
     equal the one-shot fused-dma ring bit for bit, with K4 in every round
     that moves the block and K3a in the last.
   The exact ring's ids must agree with the exact fused path's (tie-aware,
   by f64 distance, >= 0.999);
5. serve (``serve_phase``): query serving at full width. A pallas index
   over the 60000x784 corpus (k=10, bucket base 1024, depth 2) and 10000
   make_mnist_like queries (seed 1, one equal to a corpus row) streamed
   through ServeSession in batches of 256 and in ragged batches of 1..2048
   rows (buckets 1024 and 2048), for tiles exact, sweep exact and tiles
   mixed; sweep mixed (K2[c]) at its buckets only. At each bucket the
   kernel's wrapper, reading the index's staged
   corpus, is held against its plain version on the same card tensors
   (``compare``), and the kernel alone is timed beside its launch plan
   (items, waves) and bound, and the batch's device work alone (the
   host->device copy, the query prologue, the kernel, the merge, the
   device->host copy) back to back by CUDA events. Then one checked pass
   of each stream, with its gates: the corpus prologue once at build and
   never after, one query prologue and one kernel launch a batch, 0 bucket
   misses after warm, every batch equal bit for bit to all_knn on the
   card, recall@10 >= 0.999 against an f64 host oracle on 256 sampled
   queries, the duplicate query never returning its twin. Then
   SERVE_RUNS timed windows of each stream, each of at least
   SERVE_MIN_BATCHES batches (the stream repeated): q/s, latency p50/p99,
   the host's ms a batch split into centering and padding and the rest
   (launches), the event span a batch, and the card's busy share (the
   device work alone of each batch's bucket over the wall);
6. approx_kernel (run right after the build; f64 cases under "f64/",
   counted as ``approx_min_k[f64]``): the bin-minimum kernel that
   replaces the TPU's ``lax.approx_min_k`` against its plain version, bit
   for bit in values and positions, at the main path's shapes (the serial
   1024x2048 tile with k 10 and 4k = 40 raw, the stream step's 1024x2176,
   the pallas tiles' 60416x384 merge), k = 1, planted ties, +inf padding,
   -0.0 and NaN rows, and widths past shared memory (L = n = 20480 and
   60000, L = 50048 of 100000), both modes; then the fused form that
   ``smallest_k``'s approximate branches launch (``approx_smallest_k``:
   lane padding, bin minimum, id gather and mask in one launch) at the
   five path shapes (serial tile approx and approx-rerank, stream step
   approx and approx-rerank, pallas merge) and on planted ties, +inf
   entries in the stream step's 2058 real columns of 2176, -0.0 and NaN
   rows, values and ids bit for bit against its plain version (the chain
   the branches ran before). Each case prints its launch plan and is timed
   beside its plain version, torch.topk and its bound; the host's
   microseconds a call, by part, close the phase (``approx_host``);
7. run_cli (``run_cli_phase``): the C reference's own run through
   ``cli.main``: the 60000x784 corpus as an uncompressed .mat (and a small
   compressed one), loaded equal to what was written (the reader that ran
   printed); pallas exact (ids bitwise those of all_knn on the array,
   matches equal); --svd 64 (top 64 eigenvalues within 1e-4 relative of an
   f64 eigh, recall >= 0.999 against serial); exact serial twolevel, then
   approx, approx-rerank and bf16 on serial twolevel, serial stream and
   pallas tiles with --recall-vs-serial (approx >= its recall_target 0.95,
   approx-rerank >= 0.999 but on the stream schedule, over every row,
   >= STREAM_RERANK_GATE, bf16 >= 0.999; the approx kernel launched once
   per tile on serial, once on pallas tiles); query mode at SIFT1M's shape
   (1000000x128 corpus, 10000 queries, both .fvecs) through pallas tiles,
   its saved ids equal to all_knn's;
8. precision (in the kernel and main-path sections): K1, K2 (after their
   norms prologue ``stage_norms``), K3a (the P=1 shape), K4 (one P=4
   round) and K5 (the P=4 rotation) at matmul_precision "default" and
   "high" against their plain versions, ids judged by their rounded-operand
   keys; ``precision_error`` holds every final slot against f64 and against
   the oracle of rounded operands (gate: the kernel within max(1e-6, 2x the
   plain's) of that oracle); the high products alone (three bf16 matmuls);
   main paths at each precision (pallas tiles and sweep, the 4-rank
   fused-dma, bidir and grid rings) with recall@10 >= 0.999 against the
   oracle of the operands the precision multiplies (the input data's
   recall beside it); the
   planted duplicate's rank and d^2 under each precision
   (``precision_duplicates``); the serial twolevel approx path at float64
   (the f64 bin minimum, one launch a tile);
9. serve_ring (``serve_ring_phase``): the 60000x784 corpus as a ring index
   on the one card, for each cell of SERVE_RING (4 ranks: fused-dma K4,
   bidir K3a, grid K5, fused-dma at "default"; 1 rank: mixed K3b, and the
   int8 wire): the serve phase's two streams through ServeSession, every
   batch bit for bit all_knn's on the same rows and mesh, recall@10, 0
   misses after warm, the launches a batch, the shards unchanged; q/s,
   p50/p99, host ms a batch, build ms and resident bytes;
10. ivf (``ivf_phase``): the clustered index at the README's deployment
   (``build-index --data sift:100000 --partitions 256``, then ``query
   --index-load ... --batch 512``; k = 10, nprobe tuned to recall 0.95)
   for the float32, int4 and int8 stores: build seconds by stage, nprobe,
   bucket_cap, resident and probe bytes, every resident tensor on the
   card; the one-shot search of 10000 held-out rows of the corpus's
   distribution (ms, and its stages by CUDA events beside their byte
   bounds); recall@10 against an f64 oracle on 256 of them at the JAX
   package's bar for the store (0.95, 0.80, 0.95); serving in 512-row
   batches (q/s, p50, p99), every batch bit for bit the one-shot search;
   k-means run twice, the same bits; save, load by mmap, the same
   results; the query CLI's ``--index-load`` run; nprobe = partitions
   against the serial backend. No kernel of the port runs on this path
   (its launch counts stay 0): no Pallas site lies on the JAX package's;
11. kernels: one line with every kernel mode's launches, error, times and
   bound, the prologues (`stage_tf32_split`, `stage_tf32[wire]`,
   `stage_tf32_split[ring]`, `stage_bf16`, `stage_bf16[wire]`,
   `stage_norms`), the "default" / "high" forms and the approx kernel (f32
   and f64) among them.

Every kernel runs on the tensor cores. The exact K1 and K2 run wgmma: three
TF32 passes of hi/lo planes that their prologue `stage_tf32_split` writes
once with the norms, loaded by TMA; K4 on the f32 wire runs the same wgmma
tile promoted every 8 deep, on planes its own prologue
(`stage_tf32_split[ring]`) writes once per call and that travel with the
block; K3a, K5 and K4's bf16 and int8 wires run mma.sync on split f32
operands after the norm prologue `stage_tf32[wire]`; the compress ones
one bf16 pass on copies that their prologue writes with f32 norms: K1[c]
and K3b on mma.sync, K2[c] on its own wgmma tile
(`csrc/knn_wgmma_bf16.cuh`: m64n256k16 bf16 by TMA, the survivors
filtered in registers, the corpus cut into the slices that
`fused_knn.compress_sweep_plan` picks). K2[c]'s `launch_plan` lines give
its plan (slices, items, waves, grid, shared bytes) at the main shape and
at serving buckets 1024 and 2048, `product_alone` its tile's product
alone (`fused_knn.bf16_tile_dots`), and
`s_invariance` its output at forced splits against the plan's, bit for
bit, at the main shape and at bucket 1024; the serve phase holds and
times it at buckets 1024 and 2048 (`serve_kernel`, sweep mixed). The
`wgmma_8deep_vs_mma_sync` phase holds K2 built
at 8-deep promotion against K3a from an all-+inf carry at the main shape,
and the two prologues' norms, bit for bit: what lets K4 run the wgmma tile
while the rings' bitwise checks against the K3a ring stand. A kernel's `ms`
is the kernel alone on staged operands, `call_ms` the wrapper with its
prologue launches; the exact rows' bound is three times the needed FLOP at
the dense TF32 peak (`bound_ffma_ms` keeps the FP32 bound of one FFMA
product). Beside them the script prints, per kernel, registers and spilled
bytes a thread and CTAs per SM (`kernel_resources`, from
cudaFuncGetAttributes and the occupancy API; the launch plans: for K1/K2
the persistent grid and its items, for K3a, K4 and K5 rows per CTA, CTAs,
grid, items per round at each shape, and waves of the persistent grids;
the wgmma K4's setmaxnreg registers per warpgroup role from its SASS), the
count of HGMMA (wgmma: K1, K2, K2[c], K4's f32 form, their prologues) or
HMMA (mma.sync: the rest, K4's other wires among them) instructions in
its SASS (`cuobjdump -sass` of the built libraries; it must be > 0, and
K2[c] must hold no HMMA), the "product
alone" of each policy (torch.matmul on the same operands in query chunks:
bf16 copies, and f32 with TF32 off, cuBLAS's SGEMM), and the
`exact_error` phase: on every slot of K1's, K2's, K3a's and K4's
main-shape outputs (K3a and K4 at P=1), max and 99.99th percentile of
|d - d_f64| / (q^2 + c^2), the plain version's beside it; the gate is max
<= min(1e-6, the plain's) for K1 and K2 and max <= max(5e-7, 2x the
plain's) for K3a and K4. The
`exact_error_interval` phase measures K2 built with the other promotion
intervals of the wgmma tile (8 and 32 deep, and none). The `mma_ceiling`
phase measures the card's tensor-core rates (probe kernels of wgmma
m64n128k8 tf32, and of independent mma.sync tf32 m16n8k8 and bf16
m16n8k16 products) and the floors they set at the main shape: three tf32
passes, or one bf16 pass.

The last line is {"ok": true, "device": {...}}. Without a card, or without
the package beside it, the script exits non-zero and prints no result.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data sheet: FP32 (non-tensor), dense TF32 and bf16 tensor peaks,
# HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12
PRECISIONS = ("default", "high")
ERROR_GATE = 5e-7  # |d - d_f64| / (q^2 + c^2) floor of the exact_error gate
ZERO_RULE = 1e-6  # the zero-distance rule's rtol: K1/K2's error ceiling
PEAK_BYTES_PER_S = 3.35e12
RECALL_GATE = 0.999
AGREEMENT_GATE = 0.999
K = 10
OV = 4 * K  # the mixed policy's overfetch width at the main path's tiles
M_FULL = 60000
Q_TILE, C_TILE = 512, 2048  # the fused backend's clamps at the main path
SAMPLE_ROWS = 4096  # rows whose ids are judged in f64 at the largest shapes


def source_of(kernel: str) -> str:
    """The CUDA source of a kernel mode, under mpi_knn_tpu_torch/csrc/."""
    if kernel.startswith("approx_min_k"):
        return "approx_topk.cu"
    if kernel.startswith("fused_knn") or kernel in ("stage_tf32_split", "stage_bf16",
                                                    "stage_norms"):
        return "fused_knn.cu"
    if kernel.startswith(("fused_block_merge", "stage")) and not kernel.endswith("[ring]"):
        return "fused_ring.cu"
    return "fused_ring_dma.cu"


def sass_mma_counts(lib_path) -> dict:
    """{kernel function (mangled): {"HMMA": n, "HGMMA": n, "SETMAXREG":
    [...]}}, the mma.sync and wgmma instructions in its SASS and its
    register reallocations (the instructions' text), from ``cuobjdump
    -sass`` of a built kernel library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {"HMMA": 0, "HGMMA": 0, "SETMAXREG": []}
        elif cur is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
            m = re.search(r"(\w*SETMAXREG[^;]*)", line)
            if m:
                counts[cur]["SETMAXREG"].append(" ".join(m.group(1).split()))
    return counts


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mesh_ms(fn, reps: int, devices) -> float:
    """Mean milliseconds of ``fn()``: by CUDA events when every rank of
    ``devices`` is on the current card, else by the host clock between
    synchronizations of every card."""
    if len({str(d) for d in devices}) == 1:
        return cuda_ms(fn, reps)
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    return 1e3 * (time.perf_counter() - t0) / reps


def launch_device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``kernel`` over ``reps`` calls of ``fn``, by torch.profiler. For
    wrappers that synchronize after each launch (K4, K5 read their error
    word), so that host work between calls is not counted."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync_all()
    evs = [ev for ev in prof.key_averages() if kernel in ev.key]
    total = sum(getattr(ev, "device_time_total", 0) for ev in evs)
    count = sum(ev.count for ev in evs)
    if total > 0 and count > 0:
        return total / 1e3 / count
    # the profiler can miss a session's kernels: then the host clock between
    # synchronizations of every card, which the wrapper's own synchronization
    # keeps close to the launch
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    emit({"phase": "profiler_missed", "kernel": kernel, "host_clock_ms": ms})
    return ms


SPIN_CYCLES = 100_000_000  # ~50 ms of the card's clock at 1.98 GHz


def queued_ms(fn, reps: int, spin: int = SPIN_CYCLES) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, by CUDA
    events, the calls queued behind a spin kernel so that the host's time
    to issue them stays out: for calls that do not synchronize and take
    longer on the host than on the card. If the host took longer to issue
    them than the spin lasted (the host's speed varies from machine to
    machine), measures once more behind a spin four times as long, then
    raises."""
    import torch

    spun = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spun.record()
    torch.cuda._sleep(spin)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    issue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if issue_ms >= spun.elapsed_time(start):
        if spin == SPIN_CYCLES:
            return queued_ms(fn, reps, 4 * spin)
        raise AssertionError(f"issuing {reps} calls took {issue_ms:.3f} ms, "
                             "longer than the spin ahead of them")
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def centered(corpus: np.ndarray, queries=None):
    """The port's host centering (f64 mean, subtract), then f32: the corpus,
    or (corpus, queries) when queries are given."""
    from mpi_knn_tpu_torch.ops.distance import center_for_l2

    all_pairs = queries is None
    c, q = center_for_l2(corpus, corpus if all_pairs else queries, all_pairs)
    c = c.astype(np.float32)
    return c if all_pairs else (c, q.astype(np.float32))


def reset_counts():
    from mpi_knn_tpu_torch.ops import (
        approx_topk,
        fused_knn,
        fused_ring,
        fused_rotation,
    )

    fused_knn.reset_launch_counts()
    fused_ring.reset_launch_counts()
    fused_rotation.reset_launch_counts()
    approx_topk.reset_launch_counts()


def read_counts() -> dict:
    from mpi_knn_tpu_torch.ops import (
        approx_topk,
        fused_knn,
        fused_ring,
        fused_rotation,
    )

    return {**fused_knn.LAUNCHES, **fused_ring.LAUNCHES,
            **fused_rotation.LAUNCHES, **approx_topk.LAUNCHES}


def sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def rounded_dot(qr, cr, precision):
    """f64 q . c of the operands a precision multiplies: bf16-rounded
    ("default", and the compress mode), or bf16 hi + lo with lo.lo dropped
    ("high"), broadcast over the leading dimensions."""
    import torch

    b = torch.bfloat16
    if precision == "high":
        qh, ch = qr.to(b).float(), cr.to(b).float()
        ql, cl = (qr - qh).to(b).double(), (cr - ch).to(b).double()
        qh, ch = qh.double(), ch.double()
        return (ql * ch + qh * cl + qh * ch).sum(-1)
    return (qr.to(b).double() * cr.to(b).double()).sum(-1)


def true_keys(q, c, ids, compress=False, clamp=True, mask=None, precision=None):
    """f64 key of every (row r, id) of ``ids`` (R, L) from the inputs alone:
    ||q_r - c_id||^2, or in compress mode (or at ``precision`` "default" /
    "high") q^2 - 2 q.c + c^2 on the operands the product takes
    (``rounded_dot``; max 0 when ``clamp``). inf where id < 0 or
    ``mask(rows, ids)``. In row chunks of ~2^26 values."""
    import torch

    out = torch.full(ids.shape, float("inf"), dtype=torch.float64,
                     device=ids.device)
    rows = max(1, (1 << 26) // (ids.shape[1] * q.shape[1]))
    for r0 in range(0, ids.shape[0], rows):
        idc = ids[r0:r0 + rows]
        qr, cr = q[r0:r0 + rows, None, :], c[idc.clamp_min(0).long()]
        if compress or precision in ("default", "high"):
            dot = rounded_dot(qr, cr, "default" if compress else precision)
            d = ((qr.double() ** 2).sum(-1) - 2.0 * dot
                 + (cr.double() ** 2).sum(-1))
            if clamp:
                d = d.clamp_min(0.0)
        else:
            d = ((qr.double() - cr.double()) ** 2).sum(-1)
        bad = idc < 0
        if mask is not None:
            bad |= mask(torch.arange(r0, r0 + idc.shape[0],
                                     device=ids.device)[:, None], idc)
        out[r0:r0 + rows] = torch.where(bad, out[r0:r0 + rows], d)
    return out


def check_ids(name, gd, gi, m, self_ids, k, span):
    """Ids the kernel wrote, judged on their own: -1 exactly on non-finite
    slots; else below m, not the row's own id, no id twice in one list,
    and (``span`` given) inside the slot's own corpus range (list l of a
    row covers [l*span, (l+1)*span))."""
    import torch

    Q, L = gi.shape
    fin = torch.isfinite(gd)
    if not torch.equal(gi < 0, ~fin) or bool((gi < -1).any()):
        raise AssertionError(f"{name}: id -1 must mark exactly the non-finite slots")
    bad = fin & (gi >= m)
    if span is not None:
        lo = (torch.arange(L, device=gi.device) // k * span)[None, :]
        bad |= fin & ((gi < lo) | (gi >= lo + span))
    if self_ids is not None:
        bad |= fin & (gi == self_ids[:, None])
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} ids out of range or self")
    s = gi.reshape(Q, L // k, k).sort(-1).values
    if bool(((s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)).any()):
        raise AssertionError(f"{name}: an id appears twice in one list")


def compare(name, got, want, q, c, m, self_ids, exact: bool, k: int,
            span, compress=False, sample=None, precision=None) -> float:
    """Hold a kernel's (dists, ids) against its plain version's; returns the
    largest absolute distance difference over finite slots. Each sorted
    list of k is compared on its own (a tiles kernel emits one per query
    and corpus tile of ``span`` columns). The f64 checks run on the rows
    of ``sample`` when given, else on every row; at ``precision``
    "default" / "high" each id's key is that of the rounded operands."""
    import torch

    (gd, gi), (wd, wi) = got, want
    if gd.shape != wd.shape or gi.shape != wi.shape:
        raise AssertionError(f"{name}: shape {tuple(gd.shape)} != {tuple(wd.shape)}")
    check_ids(name, gd, gi, m, self_ids, k, span)
    same_nan = torch.isnan(gd) == torch.isnan(wd)
    same_inf = torch.isinf(gd) == torch.isinf(wd)
    if not bool(same_nan.all() and same_inf.all()):
        raise AssertionError(f"{name}: non-finite slots differ")
    fin = torch.isfinite(wd)
    diff = torch.where(fin, (gd - wd).abs(), torch.zeros_like(gd))
    max_err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        if not (torch.equal(gi, wi) and bool(torch.where(fin, gd == wd, True).all())):
            raise AssertionError(f"{name}: small-integer data must match bitwise")
        emit({"phase": "kernel_vs_plain", "case": name, "exact": True,
              "max_abs_err": max_err, "ok": True})
        return max_err
    if sample is not None:
        gd, gi, wd, wi, fin, diff, q = (t[sample] for t in
                                        (gd, gi, wd, wi, fin, diff, q))
    # every id is judged by its own f64 key from the inputs, never by the
    # distance the kernel reported beside it
    q_sq = (q.double() ** 2).sum(1)
    c_sq = (c.double() ** 2).sum(1)
    true_g = true_keys(q, c, gi, compress=compress, precision=precision)
    lists = gd.shape[1] // k
    shape = (-1, k)
    gd, gi, wd, wi, true_g = (t.reshape(shape) for t in (gd, gi, wd, wi, true_g))
    q_sq = q_sq.repeat_interleave(lists)[:, None]

    def tol(d, ids):
        return 1e-5 * d.abs() + 1e-4 * (q_sq + c_sq[ids.clamp_min(0).long()])

    if not bool(torch.where(fin.reshape(shape), diff.reshape(shape) <= tol(wd, wi),
                            True).all()):
        raise AssertionError(
            f"{name}: distances outside tolerance of the plain version")
    gfin = torch.isfinite(gd)
    if not bool(torch.where(gfin, (gd - true_g).abs() <= tol(true_g, gi), True).all()):
        raise AssertionError(f"{name}: a reported distance is not its id's distance")
    # tie-aware agreement: an id the plain version did not pick counts if its
    # own key is within tolerance of the plain k-th key
    in_set = (gi[:, :, None] == wi[:, None, :]).any(-1)
    tie = true_g <= wd[:, -1:] + tol(wd[:, -1:], wi[:, -1:])
    valid = wi >= 0
    agree = float(((in_set | tie) & gfin & valid).sum()) / max(int(valid.sum()), 1)
    if agree < AGREEMENT_GATE:
        raise AssertionError(f"{name}: id agreement {agree} < {AGREEMENT_GATE}")
    emit({"phase": "kernel_vs_plain", "case": name, "exact": False,
          "max_abs_err": max_err, "id_agreement": agree,
          "rows_judged_in_f64": int(gd.shape[0] // lists), "ok": True})
    return max_err


def compare_positions(name, got, want, q, rows, bids, qids, c_tile,
                      exact: bool, sample=None) -> float:
    """Hold K3b's (n_c, Q, ov) tile-local positions against the plain
    version's. Every position lies in its tile and appears once per list;
    on small integers the positions are equal. Else each chosen column is
    judged by its own f64 compressed key (inf when masked), the sorted
    keys of both lists must agree within tolerance, and the columns agree
    tie-aware at >= 0.999. Returns the largest key difference at equal
    rank."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    n_c, Q, ov = got.shape
    if bool(((got < 0) | (got >= c_tile)).any()):
        raise AssertionError(f"{name}: a position outside its tile")
    s = got.sort(-1).values
    if bool((s[..., 1:] == s[..., :-1]).any()):
        raise AssertionError(f"{name}: a position appears twice in one list")
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: small-integer data must match bitwise")
        emit({"phase": "kernel_vs_plain", "case": name, "exact": True,
              "max_abs_err": 0.0, "ok": True})
        return 0.0
    if sample is not None:
        got, want, q, qids = got[:, sample], want[:, sample], q[sample], qids[sample]
    base = (torch.arange(n_c, device=got.device) * c_tile)[:, None, None]
    # (Q, n_c*ov) block rows, lists of ov per tile
    g_rows = (got + base).permute(1, 0, 2).reshape(q.shape[0], -1)
    w_rows = (want + base).permute(1, 0, 2).reshape(q.shape[0], -1)

    def masked(r, idx):
        bid = bids[idx.long()]
        return (bid < 0) | (bid == qids[r])

    kg = true_keys(q, rows, g_rows, compress=True, clamp=False, mask=masked)
    kw = true_keys(q, rows, w_rows, compress=True, clamp=False, mask=masked)
    kg, kw = kg.reshape(-1, ov), kw.reshape(-1, ov)
    g_rows, w_rows = g_rows.reshape(-1, ov), w_rows.reshape(-1, ov)
    q_sq = (q.double() ** 2).sum(1).repeat_interleave(n_c)[:, None]
    c_sq = (rows.double() ** 2).sum(1)
    sg, sw = kg.sort(-1).values, kw.sort(-1).values
    fin = torch.isfinite(sw)
    if not torch.equal(torch.isfinite(sg), fin):
        raise AssertionError(f"{name}: masked columns chosen differently")
    c_big = c_sq[w_rows.long()].max(-1, keepdim=True).values
    tol = 1e-5 * sw.abs() + 1e-4 * (q_sq + c_big)
    diff = torch.where(fin, (sg - sw).abs(), torch.zeros_like(sg))
    if not bool((diff <= tol).all()):
        raise AssertionError(
            f"{name}: chosen keys outside tolerance of the plain version's")
    in_set = (g_rows[:, :, None] == w_rows[:, None, :]).any(-1)
    kth = sw[:, -1:]
    tie = kg <= kth + tol[:, -1:]
    agree = float((in_set | tie).sum()) / in_set.numel()
    if agree < AGREEMENT_GATE:
        raise AssertionError(f"{name}: position agreement {agree} < {AGREEMENT_GATE}")
    max_err = float(diff.max())
    emit({"phase": "kernel_vs_plain", "case": name, "exact": False,
          "max_abs_err": max_err, "id_agreement": agree,
          "rows_judged_in_f64": int(q.shape[0]), "ok": True})
    return max_err


def rel_errors(q, c, ids, d):
    """|d - d_f64| / (q^2 + c^2) of every finite slot (row r, id ids[r, j])
    of (d, ids), the f64 distance and norms from the inputs q, c; in row
    chunks of ~2^26 values."""
    import torch

    out = []
    rows = max(1, (1 << 26) // (ids.shape[1] * q.shape[1]))
    for r0 in range(0, ids.shape[0], rows):
        idc, dc = ids[r0:r0 + rows], d[r0:r0 + rows]
        qr = q[r0:r0 + rows, None, :].double()
        cr = c[idc.clamp_min(0).long()].double()
        d64 = ((qr - cr) ** 2).sum(-1)
        scale = (qr ** 2).sum(-1) + (cr ** 2).sum(-1)
        fin = torch.isfinite(dc) & (idc >= 0)
        out.append(((dc.double() - d64).abs() / scale)[fin])
    return torch.cat(out)


def rounded_errors(q, c, ids, d, precision):
    """|d - key| / (q^2 + c^2) of every finite slot against the f64 key of
    the operands ``precision`` multiplies (``rounded_dot``, clamped at 0),
    and the same key's own distance from the f64 distance; row chunks."""
    import torch

    to_key, key_to_f64 = [], []
    rows = max(1, (1 << 26) // (ids.shape[1] * q.shape[1]))
    for r0 in range(0, ids.shape[0], rows):
        idc, dc = ids[r0:r0 + rows], d[r0:r0 + rows]
        qr = q[r0:r0 + rows, None, :]
        cr = c[idc.clamp_min(0).long()]
        qs, cs = (qr.double() ** 2).sum(-1), (cr.double() ** 2).sum(-1)
        key = (qs + cs - 2.0 * rounded_dot(qr, cr, precision)).clamp_min(0.0)
        d64 = ((qr.double() - cr.double()) ** 2).sum(-1)
        fin = torch.isfinite(dc) & (idc >= 0)
        to_key.append(((dc.double() - key).abs() / (qs + cs))[fin])
        key_to_f64.append(((key - d64).abs() / (qs + cs))[fin])
    return torch.cat(to_key), torch.cat(key_to_f64)


def precision_error(name, precision, q, c, got, want) -> dict:
    """The precision_error line: max |d - d_f64| / (q^2 + c^2) of the
    kernel and of its plain version, beside the oracle of rounded operands
    (its own distance from f64, and each one's distance from it). Fails
    when the kernel strays from the rounded oracle past max(1e-6, 2x the
    plain version's): the zero rule's rtol, the accuracy the masks need of
    the product the precision asks for."""
    import torch

    def stats(e):
        return {"max": float(e.max()), "p99_99": float(torch.quantile(e, 0.9999)),
                "pairs": int(e.numel())}

    k_key, oracle = rounded_errors(q, c, got[1], got[0], precision)
    p_key, _ = rounded_errors(q, c, want[1], want[0], precision)
    line = {"phase": "precision_error", "kernel": name, "precision": precision,
            "kernel_err": stats(rel_errors(q, c, got[1], got[0])),
            "plain_err": stats(rel_errors(q, c, want[1], want[0])),
            "rounded_oracle_err": stats(oracle),
            "kernel_vs_rounded_oracle": stats(k_key),
            "plain_vs_rounded_oracle": stats(p_key)}
    line["gate"] = max(ZERO_RULE, 2.0 * line["plain_vs_rounded_oracle"]["max"])
    line["ok"] = line["kernel_vs_rounded_oracle"]["max"] <= line["gate"]
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"{name}: strays from the rounded oracle by "
                             f"{line['kernel_vs_rounded_oracle']['max']}")
    return line


def exact_error(name, q, c, got, want, strict=False) -> dict:
    """The exact_error line of a kernel's (dists, ids) and its plain
    version's on the same inputs; fails past the gate: max(5e-7, 2x the
    plain version's), or with ``strict`` (the wgmma tile of K1/K2) the zero
    rule's 1e-6 and no more than the plain version's."""
    import torch

    def stats(e):
        return {"max": float(e.max()), "p99_99": float(torch.quantile(e, 0.9999)),
                "pairs": int(e.numel())}

    line = {"phase": "exact_error", "kernel": name,
            "kernel_err": stats(rel_errors(q, c, got[1], got[0])),
            "plain_err": stats(rel_errors(q, c, want[1], want[0]))}
    plain_max = line["plain_err"]["max"]
    line["gate"] = (min(ZERO_RULE, plain_max) if strict
                    else max(ERROR_GATE, 2.0 * plain_max))
    line["ok"] = line["kernel_err"]["max"] <= line["gate"]
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"{name}: exact error {line['kernel_err']['max']} "
                             f"over the gate {line['gate']}")
    return line


def kernel_cases(device):
    """(name, queries, corpus, m_corpus, all_pairs, exact, k, q_tile,
    c_tile) on the card."""
    import torch

    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple

    rng = np.random.default_rng(0)
    small = (rng.integers(0, 8, (1000, 64)) * 0.25).astype(np.float32)
    small[5] = small[60]  # an exact duplicate pair
    nanq = (rng.integers(0, 8, (200, 64)) * 0.25).astype(np.float32)
    nanq[3] = np.nan
    X8, _ = make_mnist_like(8192)
    X6, _ = make_mnist_like(6000, seed=1)
    qmode_c, qmode_q = centered(X6[:5000], X6[5000:])

    cases = [
        ("small_int_all_pairs", small, small, True, True, K, 128, 256),
        ("small_int_nan_query", nanq, small, False, True, K, 128, 256),
        # k above the kernels' shared-memory list limit (lists in the output)
        ("small_int_k150", small, small, True, True, 150, 128, 256),
        ("mnist8192_all_pairs", centered(X8), centered(X8), True, False, K,
         Q_TILE, C_TILE),
        ("mnist5000_query_mode", qmode_q, qmode_c, False, False, K, Q_TILE,
         C_TILE),
    ]
    for name, q, c, all_pairs, exact, k, qt, ct in cases:
        qp = pad_rows_any(q, pad_to_multiple(len(q), qt), dtype=torch.float32,
                          device=device)
        cp = pad_rows_any(c, pad_to_multiple(len(c), ct), dtype=torch.float32,
                          device=device)
        yield name, qp, cp, len(c), all_pairs, exact, k, qt, ct


def ring_small_cases(device, seed=1, id_base=0):
    """Small-integer K3a/K3b operands on each wire: rows of integers in
    [-127, 127] over 16 with one +-127/16 entry (exact in f32 and bf16,
    lossless in int8), rotated block ids with -1 padding, a duplicate of a
    query, a query whose own id is in the block, and a carry of real block
    distances under lower ids (ties)."""
    import torch

    from mpi_knn_tpu_torch.ops.quant import quantize_rows

    rng = np.random.default_rng(seed)

    def rows(n, dim=96):
        x = rng.integers(-127, 128, (n, dim)).astype(np.float32)
        x[np.arange(n), rng.integers(0, dim, n)] = 127.0
        return x / 16

    q, blk = rows(300), rows(1024)
    blk[100] = q[4]
    bids = (rng.permutation(50000)[:1024] + 1000 + id_base).astype(np.int32)
    bids[-40:] = -1
    qids = np.arange(300, dtype=np.int32) + 60000
    qids[7] = bids[500]
    d = ((q[:, None].astype(np.float64) - blk[None]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    cd = np.take_along_axis(d, order[:, 2:2 + K], 1).astype(np.float32)
    ci = np.stack([rng.choice(1000, K, replace=False)
                   for _ in range(300)]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    for wire in ("float32", "bfloat16", "int8"):
        b, scale = t(blk), None
        if wire == "int8":
            b, scale = quantize_rows(b)
        elif wire == "bfloat16":
            b = b.to(torch.bfloat16)
        yield wire, (t(q), t(qids), b, t(bids), scale), (t(cd), t(ci))


SERVE_QUERIES = 10000  # make_mnist_like(10000, seed=1): the serve phase's stream
SERVE_BUCKET = 1024
SERVE_VARIANTS = (("tiles", "exact"), ("sweep", "exact"), ("tiles", "mixed"))
# variants held and timed at their buckets only (no streams): K2[c]
SERVE_KERNEL_ONLY = (("sweep", "mixed"),)
DUP_QUERY, DUP_ROW = 4321, 777  # the serve stream's query equal to a corpus row
SERVE_RUNS = 3  # timed windows of each stream: the spread across runs
SERVE_MIN_BATCHES = 120  # batches in one timed window, so p99 has >= 100


def serve_streams(rng_seed: int = 3):
    """The serve phase's two batch-size streams over SERVE_QUERIES rows:
    (a) batches of 256, the CLI's default; (b) ragged sizes from a seed in
    1..2048, so buckets 1024 and 2048 both appear."""
    sizes_b, left = [], SERVE_QUERIES
    rng = np.random.default_rng(rng_seed)
    while left:
        sizes_b.append(min(left, int(rng.integers(1, 2049))))
        left -= sizes_b[-1]
    if not any(n > SERVE_BUCKET for n in sizes_b):
        raise AssertionError("stream (b) never reaches bucket 2048")
    sizes_a = [256] * (SERVE_QUERIES // 256) + (
        [SERVE_QUERIES % 256] if SERVE_QUERIES % 256 else [])
    return {"a_256": sizes_a, "b_ragged": sizes_b}


def serve_inputs(device, X) -> dict:
    """The serving phases' inputs: SERVE_QUERIES make_mnist_like queries
    (seed 1, DUP_QUERY equal to corpus row DUP_ROW), the streams, all_knn's
    own host centering of both (f64) and its f32 rows on the card, and the
    f64 oracle of 256 sampled queries (the duplicate among them): the zero
    rule d <= 1e-6 (q^2 + c^2) on the centered rows, ties to the lower
    id."""
    import torch

    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops.distance import center_for_l2

    Qs, _ = make_mnist_like(SERVE_QUERIES, seed=1)
    Qs[DUP_QUERY] = X[DUP_ROW]
    Xc64, Qc64 = center_for_l2(X, Qs, all_pairs=False)
    picks = np.unique(np.r_[np.linspace(0, SERVE_QUERIES - 1, 255).astype(int),
                            DUP_QUERY])
    return {"Qs": Qs, "streams": serve_streams(), "Xc64": Xc64, "Qc64": Qc64,
            "Xc_dev": torch.from_numpy(Xc64).to(torch.float32).to(device),
            "Qc_dev": torch.from_numpy(Qc64).to(torch.float32).to(device),
            "picks": picks, "want_ids": serve_oracle(Qc64[picks], Xc64)}


def host_dot(q, c, precision=None):
    """f64 q . c^T on the host of the operands a precision multiplies: the
    rows themselves, or (``rounded_dot``) their f32 values rounded to bf16
    ("default") or split into bf16 hi + lo ("high")."""
    import torch

    if precision is None:
        return q @ c.T
    b = torch.bfloat16

    def parts(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
        hi = x.to(b).float()
        return hi.double().numpy(), (x - hi).to(b).double().numpy()

    (qh, ql), (ch, cl) = parts(q), parts(c)
    if precision == "default":
        return qh @ ch.T
    return ql @ ch.T + qh @ cl.T + qh @ ch.T


def serve_oracle(q, c, rtol=1e-6, precision=None, self_rows=None):
    """f64 ids of each query's K nearest rows of c: the zero rule
    d <= rtol (q^2 + c^2), ties to the lower id; at ``precision`` the
    product of the rounded operands (``host_dot``); ``self_rows`` (one per
    query) excluded."""
    q_sq, c_sq = (q ** 2).sum(1)[:, None], (c ** 2).sum(1)[None, :]
    d = np.maximum(q_sq + c_sq - 2.0 * host_dot(q, c, precision), 0.0)
    d[d <= rtol * (q_sq + c_sq)] = np.inf
    if self_rows is not None:
        d[np.arange(len(self_rows)), self_rows] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :K]


def serve_phase(device, X, inputs) -> dict:
    """Query serving at full width: a pallas index over the 60000x784
    corpus X (k=10, bucket base 1024, depth 2), and SERVE_QUERIES
    make_mnist_like queries (seed 1, one of them a corpus row) streamed
    through ServeSession as serve_streams() cuts them, for tiles exact,
    sweep exact and tiles mixed. Gates, per variant: at each bucket the
    kernel's wrapper on the staged corpus against its plain version; the
    corpus prologue launched once at build and never after; per batch one
    query prologue and one kernel launch; 0 bucket misses after warm, in
    the checked pass and in every timed window; every batch equal bit for
    bit to all_knn on the card on the same rows; recall@10 >= 0.999 against
    an f64 host oracle on 256 sampled queries; the duplicate query never
    returns its twin. Returns {kernel: largest |d - plain d|}."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, ServeSession, all_knn, build_index
    from mpi_knn_tpu_torch.ops import fused_knn
    from mpi_knn_tpu_torch.serve import engine
    from mpi_knn_tpu_torch.utils.report import recall_at_k

    t_phase = time.perf_counter()
    # all_knn's own host centering (f64 mean and subtraction), once: the
    # reference calls get the same f32 rows with center=False
    Qs, streams, Xc_dev, Qc_dev = (inputs[k] for k in ("Qs", "streams", "Xc_dev",
                                                         "Qc_dev"))
    picks, want_ids = inputs["picks"], inputs["want_ids"]
    max_err = {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for variant, policy in SERVE_VARIANTS + SERVE_KERNEL_ONLY:
        label = f"pallas/{variant}/{policy}"
        kernel_only = (variant, policy) in SERVE_KERNEL_ONLY
        kw = dict(k=K, backend="pallas", pallas_variant=variant,
                  precision_policy=policy, query_bucket=SERVE_BUCKET,
                  dispatch_depth=2)
        compress = policy == "mixed"
        kernel = f"fused_knn_{variant}" + ("[compress]" if compress else "")
        q_stage = "stage_bf16" if compress else "stage_tf32_split"
        sync_all()
        mem0 = torch.cuda.memory_allocated(device)
        reset_counts()
        t0 = time.perf_counter()
        index = build_index(X, KNNConfig(**kw), device=device)
        sync_all()
        build_ms = 1e3 * (time.perf_counter() - t0)
        resident = torch.cuda.memory_allocated(device) - mem0
        build_counts = {k: v for k, v in read_counts().items() if v}
        session = ServeSession(index, device=device)
        cfg = session.cfg
        all_sizes = [n for sizes in streams.values() for n in sizes]
        warm = None if kernel_only else session.warm(all_sizes)
        buckets = sorted({engine.bucket_rows(n, SERVE_BUCKET) for n in all_sizes})
        for n in buckets:
            list(session.stream([Qs[:n]]))  # the warm-up batch of each bucket
        emit({"phase": "serve_build", "path": label, "m": M_FULL, "d": X.shape[1],
              "k": K, "index_build_ms": build_ms, "resident_bytes": resident,
              "nbytes_resident": index.nbytes_resident,
              "launches_at_build": build_counts, "warm": warm})
        if build_counts != {q_stage: 1}:
            raise AssertionError(f"serve {label}: build launches {build_counts}, "
                                 f"expected {{{q_stage!r}: 1}}")
        # at each bucket: the wrapper on the staged corpus against its plain
        # version on the same card tensors; the kernel alone beside its
        # launch plan and bound; the batch's device work alone, back to back
        card_ms = {}
        cp = index.corpus_padded
        wrapper = getattr(fused_knn, f"fused_knn_{variant}")
        plain = getattr(fused_knn, f"fused_knn_{variant}_reference")
        for bucket in buckets:
            exec_ = engine.get_executable(index, cfg, bucket)
            qb = Qc_dev[:bucket].contiguous()
            kk = 4 * K if compress else (
                K if variant == "sweep" else min(K, index.c_tile))
            args = (qb, cp, M_FULL, kk, exec_.q_tile, index.c_tile)
            opts = dict(all_pairs=False, compress=compress)
            got = wrapper(*args, staged_corpus=index.staged, **opts)
            torch.cuda.synchronize()
            want = plain(*args, **opts)
            err = compare(f"{kernel}/serve_bucket{bucket}", got, want, qb, cp,
                          M_FULL, None, False, kk,
                          index.c_tile if variant == "tiles" else cp.shape[0],
                          compress=compress)
            max_err[kernel] = max(max_err.get(kernel, 0.0), err)
            plain_ms = cuda_ms(lambda: plain(*args, **opts), reps=2)  # noqa: B023
            if compress:
                sq = fused_knn.stage_bf16_rows(qb)
                run = lambda: fused_knn.launch_compress(  # noqa: E731
                    f"fused_knn_{variant}", sq, index.staged.compress, M_FULL,
                    kk, index.c_tile, all_pairs=False)
                plan = None
                if variant == "sweep":  # K2[c]'s corpus split at this bucket
                    plan = fused_knn.compress_sweep_launch_plan(
                        bucket, cp.shape[0], M_FULL, kk,
                        fused_knn.compress_sweep_plan(bucket, M_FULL, sms)["slices"])
            else:
                sq = fused_knn.stage_tf32_split(qb)
                run = lambda: fused_knn.launch_exact(  # noqa: E731
                    f"fused_knn_{variant}", sq, index.staged.exact, M_FULL, kk,
                    index.c_tile, all_pairs=False)
                plan = fused_knn.exact_plan(f"fused_knn_{variant}", bucket,
                                            cp.shape[0], index.c_tile, kk)
            run()
            ms = cuda_ms(run, reps=5)
            slot = exec_.acquire()
            slot.host_in.copy_(qb.cpu())

            def device_part():  # what one batch's dispatch puts on the card
                d, i = engine._run(index, cfg, exec_,  # noqa: B023
                                   slot.host_in.to(device, non_blocking=True))  # noqa: B023
                slot.out_d.copy_(d, non_blocking=True)  # noqa: B023
                slot.out_i.copy_(i, non_blocking=True)  # noqa: B023

            device_part()
            card_ms[bucket] = cuda_ms(device_part, reps=10)
            exec_.release(slot)
            ops = 2.0 * bucket * M_FULL * X.shape[1] * (1 if compress else 3)
            peak = PEAK_BF16_FLOPS if compress else PEAK_TF32_FLOPS
            emit({"phase": "serve_kernel", "path": label, "kernel": kernel,
                  "bucket": bucket, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": 1e3 * ops / peak,
                  "bound_by": "operations", "plan": plan,
                  "batch_device_ms": card_ms[bucket]})
        if kernel_only:
            del session, index
            continue
        for name, sizes in streams.items():
            batches, r0 = [], 0
            for n in sizes:
                batches.append(Qs[r0:r0 + n])
                r0 += n
            nb = len(batches)
            # the checked pass: the stream once, its launches counted
            session.reset_stats()
            engine.reset_misses()
            reset_counts()
            sync_all()
            results = list(session.stream(batches))
            counts = {k: v for k, v in read_counts().items() if v}
            misses = engine.MISSES
            # every batch against all_knn on the same f32 rows; the first
            # batch also against all_knn's own host centering of X
            equal, r0 = 0, 0
            for i, res in enumerate(results):
                n = res.rows
                want = all_knn(Xc_dev, queries=Qc_dev[r0:r0 + n], center=False,
                               device=device, **kw)
                same = (np.array_equal(res.ids, want.ids.cpu().numpy())
                        and np.array_equal(res.dists, want.dists.cpu().numpy()))
                if i == 0:
                    raw = all_knn(X, queries=batches[0], device=device, **kw)
                    same = same and torch.equal(raw.ids, want.ids) and torch.equal(
                        raw.dists, want.dists)
                equal += same
                r0 += n
            ids = np.concatenate([r.ids for r in results])
            rec = recall_at_k(ids[picks], want_ids)
            dup_ok = DUP_ROW not in ids[DUP_QUERY].tolist()
            emit({"phase": "serve_check", "path": label, "stream": name,
                  "batches": nb, "queries": int(sum(sizes)),
                  "buckets": sorted({r.bucket for r in results}),
                  "bucket_misses_after_warm": misses, "launches": counts,
                  "launches_per_batch": {k: v / nb for k, v in counts.items()},
                  "batches_equal_to_all_knn": equal, "recall_at_10": rec,
                  "duplicate_dropped": dup_ok})
            expect = {kernel: nb, q_stage: nb}
            if counts != expect:
                raise AssertionError(f"serve {label}/{name}: launches {counts}, "
                                     f"expected {expect}")
            if misses:
                raise AssertionError(f"serve {label}/{name}: {misses} bucket misses")
            if equal != nb:
                raise AssertionError(f"serve {label}/{name}: {nb - equal} of {nb} "
                                     "batches differ from all_knn")
            if rec < RECALL_GATE:
                raise AssertionError(f"serve {label}/{name}: recall@10 {rec}")
            if not dup_ok:
                raise AssertionError(f"serve {label}/{name}: the duplicate query "
                                     "returned its twin")
            # the timed windows: the stream repeated to SERVE_MIN_BATCHES
            window = batches * -(-SERVE_MIN_BATCHES // nb)
            runs = []
            for _ in range(SERVE_RUNS):
                session.reset_stats()
                engine.reset_misses()
                sync_all()
                t0 = time.perf_counter()
                results = list(session.stream(window))
                wall = time.perf_counter() - t0
                if engine.MISSES:
                    raise AssertionError(f"serve {label}/{name}: "
                                         f"{engine.MISSES} bucket misses")
                lats = np.asarray(session.latencies) * 1e3
                host = [r.host_ms for r in results]
                prep = [r.prep_ms for r in results]
                busy = sum(card_ms[r.bucket] for r in results)
                runs.append({
                    "wall_s": wall, "qps": session.queries_served / wall,
                    "latency_p50_ms": float(np.percentile(lats, 50)),
                    "latency_p99_ms": float(np.percentile(lats, 99)),
                    "host_ms_median": statistics.median(host),
                    "host_prep_ms_median": statistics.median(prep),
                    "host_launch_ms_median": statistics.median(
                        [h - p for h, p in zip(host, prep)]),
                    "span_ms_median": statistics.median(
                        [r.device_ms for r in results]),
                    "card_busy_share": busy / (1e3 * wall)})
            qps = [r["qps"] for r in runs]
            emit({"phase": "serve", "path": label, "stream": name,
                  "batches_per_run": len(window),
                  "queries_per_run": len(window) // nb * int(sum(sizes)),
                  "qps_min": min(qps), "qps_median": statistics.median(qps),
                  "qps_max": max(qps), "runs": runs,
                  "peak_hbm_bytes": torch.cuda.max_memory_allocated(device)})
        del session, index
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t_phase})
    return max_err


SERVE_RING_BUCKET = 256
# the ring serving cells, every rank on the one card: (label, ranks, config,
# the launches a batch makes: its kernel(s) and the query-side prologue)
SERVE_RING = (
    ("P4/fused-dma/exact", 4, dict(ring_fusion="fused"),
     {"fused_round_dma": 4, "stage_tf32_split[ring]": 4}),
    ("P4/fused/bidir/exact", 4, dict(ring_fusion="fused", ring_schedule="bidir"),
     {"fused_block_merge[exact]": 16, "stage_tf32[wire]": 4}),
    ("P4/fused-grid/exact", 4, dict(ring_fusion="fused", ring_fused_rotation="grid"),
     {"fused_rotation_grid": 1, "stage_tf32[wire]": 4}),
    ("P4/fused-dma/default", 4, dict(ring_fusion="fused", matmul_precision="default"),
     {"fused_round_dma[default]": 4, "stage_tf32[wire]": 4}),
    ("P1/fused/mixed", 1, dict(ring_fusion="fused", precision_policy="mixed"),
     {"fused_block_merge[compress]": 1, "stage_bf16[wire]": 2}),
    ("P1/fused/mixed/int8", 1, dict(ring_fusion="fused", precision_policy="mixed",
                                    ring_transfer_dtype="int8"),
     {"fused_block_merge[compress]": 1, "stage_bf16[wire]": 2}),
)


def serve_ring_phase(device, X, inputs):
    """Ring serving at full width: the 60000x784 corpus X as a ring-overlap
    index of P ranks on the one card (bucket base SERVE_RING_BUCKET, depth
    2), and the serve phase's queries in the 256-row and the ragged stream,
    for each cell of SERVE_RING. Gates: at build the corpus-side prologue
    once per rank (what the build config's form reads: K4's planes, the
    norms, or nothing for K3b); 0 bucket misses after warm; per batch the
    cell's launches (K4: one per round, K3a: one per merge, K5: one, K3b:
    one, each with its query prologue); every batch equal bit for bit to
    all_knn on the card on the same rows and mesh; recall@10 against the
    f64 oracle of 256 sampled queries (the int8 wire's against its
    dequantized rows', ROADMAP C.4; "default" against the oracle of its
    rounded operands) at the exact gate, the input data's recall printed
    beside; the duplicate query dropped on the exact and mixed f32
    cells; the resident shards unchanged by the stream (only read). Then
    one timed window of each stream: q/s, p50/p99, host ms a batch."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, ServeSession, all_knn, build_index
    from mpi_knn_tpu_torch.ops.quant import dequantize_rows, quantize_rows
    from mpi_knn_tpu_torch.serve import engine
    from mpi_knn_tpu_torch.utils.report import recall_at_k

    t_phase = time.perf_counter()
    Qs, streams, Xc_dev, Qc_dev = (inputs[k] for k in ("Qs", "streams", "Xc_dev",
                                                         "Qc_dev"))
    picks = inputs["picks"]
    wire_rows = dequantize_rows(*quantize_rows(Xc_dev)).double().cpu().numpy()
    want_wire = serve_oracle(inputs["Qc64"][picks], wire_rows)
    del wire_rows
    q32 = inputs["Qc64"][picks].astype(np.float32).astype(np.float64)
    x32 = inputs["Xc64"].astype(np.float32).astype(np.float64)
    want_rounded = {p: serve_oracle(q32, x32, precision=p) for p in PRECISIONS}
    del q32, x32
    all_sizes = [n for sizes in streams.values() for n in sizes]
    buckets = sorted({engine.bucket_rows(n, SERVE_RING_BUCKET) for n in all_sizes})
    for label, P, extra, per_batch in SERVE_RING:
        t_cell = time.perf_counter()
        mesh = [device] * P
        kw = dict(k=K, backend="ring-overlap", query_bucket=SERVE_RING_BUCKET,
                  dispatch_depth=2, **extra)
        precision = extra.get("matmul_precision")
        int8 = extra.get("ring_transfer_dtype") == "int8"
        oracle = (want_wire if int8 else want_rounded[precision] if precision
                  else inputs["want_ids"])
        form_stage = next(iter(k for k in per_batch if k.startswith("stage")))
        expect_build = {} if "compress" in next(iter(per_batch)) else {form_stage: P}
        sync_all()
        mem0 = torch.cuda.memory_allocated(device)
        reset_counts()
        t0 = time.perf_counter()
        index = build_index(X, KNNConfig(**kw), device=device, mesh=mesh)
        sync_all()
        build_ms = 1e3 * (time.perf_counter() - t0)
        resident = torch.cuda.memory_allocated(device) - mem0
        build_counts = {k: v for k, v in read_counts().items() if v}
        before = [tuple(None if t is None else t.clone() for t in sh) for sh in index.shards]
        session = ServeSession(index, device=device)
        warm = session.warm(all_sizes)
        for n in buckets:
            list(session.stream([Qs[:n]]))  # the warm-up batch of each bucket
        emit({"phase": "serve_build", "path": f"ring/{label}", "m": M_FULL,
              "d": X.shape[1], "k": K, "ranks": P, "c_tile": index.c_tile,
              "index_build_ms": build_ms, "resident_bytes": resident,
              "nbytes_resident": index.nbytes_resident, "staged_parts": index.ring_parts,
              "launches_at_build": build_counts, "warm": warm})
        if build_counts != expect_build:
            raise AssertionError(f"serve ring/{label}: build launches {build_counts}, "
                                 f"expected {expect_build}")
        for name, sizes in streams.items():
            batches, r0 = [], 0
            for n in sizes:
                batches.append(Qs[r0:r0 + n])
                r0 += n
            nb = len(batches)
            session.reset_stats()
            engine.reset_misses()
            reset_counts()
            sync_all()
            results = list(session.stream(batches))
            counts = {k: v for k, v in read_counts().items() if v}
            misses = engine.MISSES
            # the int8 wire quantizes the corpus where it lies, so its all_knn
            # takes the host rows, as the index was built from them
            ref_corpus = inputs["Xc64"].astype(np.float32) if int8 else Xc_dev
            equal, r0 = 0, 0
            for res in results:
                want = all_knn(ref_corpus, queries=Qc_dev[r0:r0 + res.rows],
                               center=False, mesh=mesh, device=device, **kw)
                equal += (np.array_equal(res.ids, want.ids.cpu().numpy())
                          and np.array_equal(res.dists, want.dists.cpu().numpy()))
                r0 += res.rows
            ids = np.concatenate([r.ids for r in results])
            rec = recall_at_k(ids[picks], oracle)
            rec_input = recall_at_k(ids[picks], inputs["want_ids"])
            dup_dropped = DUP_ROW not in ids[DUP_QUERY].tolist()
            expect = {k: v * nb for k, v in per_batch.items()}
            emit({"phase": "serve_check", "path": f"ring/{label}", "stream": name,
                  "batches": nb, "queries": int(sum(sizes)),
                  "buckets": sorted({r.bucket for r in results}),
                  "bucket_misses_after_warm": misses, "launches": counts,
                  "launches_per_batch": {k: v / nb for k, v in counts.items()},
                  "batches_equal_to_all_knn": equal, "recall_at_10": rec,
                  "recall_oracle": ("dequantized rows" if int8 else
                                    f"rounded operands ({precision})" if precision
                                    else "input data"),
                  "recall_at_10_input_data": rec_input,
                  "duplicate_dropped": dup_dropped})
            if counts != expect:
                raise AssertionError(f"serve ring/{label}/{name}: launches {counts}, "
                                     f"expected {expect}")
            if misses:
                raise AssertionError(f"serve ring/{label}/{name}: {misses} misses")
            if equal != nb:
                raise AssertionError(f"serve ring/{label}/{name}: {nb - equal} of {nb} "
                                     "batches differ from all_knn")
            if rec < RECALL_GATE:
                raise AssertionError(f"serve ring/{label}/{name}: recall@10 {rec}")
            if not dup_dropped and precision is None and not int8:
                raise AssertionError(f"serve ring/{label}/{name}: the duplicate query "
                                     "returned its twin")
            session.reset_stats()
            engine.reset_misses()
            sync_all()
            t0 = time.perf_counter()
            results = list(session.stream(batches))
            wall = time.perf_counter() - t0
            if engine.MISSES:
                raise AssertionError(f"serve ring/{label}/{name}: misses in the window")
            lats = np.asarray(session.latencies) * 1e3
            host = [r.host_ms for r in results]
            emit({"phase": "serve", "path": f"ring/{label}", "stream": name,
                  "batches": nb, "wall_s": wall, "qps": session.queries_served / wall,
                  "latency_p50_ms": float(np.percentile(lats, 50)),
                  "latency_p99_ms": float(np.percentile(lats, 99)),
                  "host_ms_median": statistics.median(host),
                  "host_prep_ms_median": statistics.median([r.prep_ms for r in results]),
                  "span_ms_median": statistics.median([r.device_ms for r in results]),
                  "peak_hbm_bytes": torch.cuda.max_memory_allocated(device)})
        sync_all()
        unchanged = all(
            (a is None) == (b is None) and (a is None or torch.equal(a, b))
            for sh0, sh in zip(before, index.shards) for a, b in zip(sh0, sh))
        emit({"phase": "serve_ring_shards", "path": f"ring/{label}",
              "shards_unchanged": unchanged, "seconds": time.perf_counter() - t_cell})
        if not unchanged:
            raise AssertionError(f"serve ring/{label}: a resident shard was written")
        del session, index, before
    emit({"phase": "serve_ring_done", "seconds": time.perf_counter() - t_phase})


# the approximate top-k kernel's shapes: (case, rows, columns, k, aggregate,
# recall_target); the serial twolevel tile (approx: k, approx-rerank: 4k
# raw), the stream step's carry + tile padded to 2176, the pallas tiles'
# cross-tile merge of 30 x 10 survivors padded to 384, the edge rows, and
# widths past a CTA's shared memory (L = n, and L = 50048 < n), and L = n
# not a multiple of 4 in each plan (warp, cta, two passes)
APPROX_CASES = (("tile_k10", 1024, 2048, K, True, 0.95),
                ("tile_rerank", 1024, 2048, OV, False, 0.95),
                ("stream_k10", 1024, 2176, K, True, 0.95),
                ("stream_rerank", 1024, 2176, OV, False, 0.95),
                ("merge_k10", 60416, 384, K, True, 0.95),
                ("k1", 1024, 2048, 1, True, 0.95),
                ("planted_ties", 1024, 2048, K, True, 0.95),
                ("inf_padding", 1024, 2176, K, True, 0.95),
                ("zeros_nan", 1024, 2048, K, True, 0.95),
                ("wide_k120", 64, 20480, 120, True, 0.99),
                ("wide_raw", 64, 20480, 120, False, 0.99),
                ("full_k128", 16, 60000, 128, True, 0.999),
                ("full_raw", 16, 60000, 128, False, 0.999),
                ("reduced_k256", 8, 100000, 256, True, 0.99),
                ("reduced_raw", 8, 100000, 256, False, 0.99),
                ("odd_warp", 1024, 301, K, True, 0.95),
                ("odd_warp_raw", 1024, 301, K, False, 0.95),
                ("odd_cta", 256, 1155, OV, True, 0.95),
                ("odd_cta_raw", 256, 1155, OV, False, 0.95),
                ("odd_two_pass", 64, 20481, 120, True, 0.99),
                ("odd_two_pass_raw", 64, 20481, 120, False, 0.99))
# the fused form (smallest_k's approximate branches): (case, rows, real
# columns, (c,) ids, method); k = K
FUSED_CASES = (("tile_k10", 1024, 2048, True, "approx"),
               ("tile_rerank", 1024, 2048, True, "approx-rerank"),
               ("stream_k10", 1024, 2058, False, "approx"),
               ("stream_rerank", 1024, 2058, False, "approx-rerank"),
               ("merge_k10", 60416, 300, False, "approx"),
               ("planted_ties", 1024, 2058, False, "approx-rerank"),
               ("inf_entries", 1024, 2058, False, "approx"),
               ("zeros_nan", 1024, 2058, False, "approx-rerank"))
# f64 rows (the reference's f64 mode): 16-byte keys in every plan, the
# main path's shapes and the edge rows, and the fused form at the serial tile
APPROX_F64_CASES = ("tile_k10", "tile_rerank", "stream_rerank", "planted_ties",
                    "zeros_nan", "wide_raw", "odd_cta_raw", "odd_two_pass")
FUSED_F64_CASES = ("tile_k10", "tile_rerank", "stream_k10", "zeros_nan")
RECALL_TARGET = 0.95  # the config's default, which the run_cli phase uses
HOST_CALLS = 1000  # calls a host part is timed over (none synchronizes)
# serial stream approx-rerank, recall over all 60000 rows: the card read
# 0.99816-0.99842 on seeds 0-4 of make_mnist_like (0.99840 on seed 0, the
# smoke's; tools/approx_recall.py), its recall_target is 0.95; a path that
# lost twice the neighbours would read about 0.9968
STREAM_RERANK_GATE = 0.997


def approx_rows(rng, case, rows, n, dtype=np.float32):
    """A case's rows: planted ties (a few values, each column tied many
    times), squared normals otherwise; +inf, -0.0 and NaN planted by name."""
    if case == "planted_ties":
        x = rng.integers(0, 6, (rows, n)).astype(dtype)
    else:  # squared distances
        x = rng.standard_normal((rows, n)).astype(dtype) ** 2
    if case == "inf_padding":  # the stream step's lane padding
        x[:, 2058:] = np.inf
        x[7] = np.inf
    elif case == "inf_entries":
        x[:, ::3] = np.inf
        x[7] = np.inf
    elif case == "zeros_nan":
        x[1, ::3] = -0.0
        x[2] = 0.0
        x[4, ::5] = np.nan
        x[5] = np.nan
    return x


def approx_entry(call, plain, topk, same, got_v, want_v, plan, t_bytes, t_ops,
                 reps=20):
    """Times and bound of one approx case (device times queued behind a
    spin, means of ``reps``; the call alone by CUDA events, mean of 3)."""
    return {"plan": plan, "bitwise_equal": same,
            "max_abs_err": float((got_v - want_v).abs().nan_to_num(0.0).max()),
            "ms": queued_ms(call, reps), "call_ms": cuda_ms(call, reps=3),
            "plain_ms": queued_ms(plain, reps), "topk_ms": queued_ms(topk, reps),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def approx_kernel_phase(device) -> dict:
    """The bin-minimum kernel against its plain version on the card, bit
    for bit (values and positions) at every case of APPROX_CASES, then its
    fused form (``approx_smallest_k``, as ``smallest_k`` calls it) against
    the plain chain (values and ids) at every case of FUSED_CASES; each
    with its launch plan, timed (device times of the kernel, of the plain
    version and of torch.topk on the same rows, the exact function the
    method approximates) beside its bound (the rows read once, the
    gathered ids and the outputs written once, at the HBM rate; one
    compare a column at the FP32 rate). Each call must launch once. Then
    the host's microseconds a call by part (``approx_host``). Returns
    {case: entry} (fused cases under "fused/<case>")."""
    import torch

    from mpi_knn_tpu_torch.ops import approx_topk
    from mpi_knn_tpu_torch.ops.topk import smallest_k

    rng = np.random.default_rng(21)
    out = {}

    def launched_once(name, fn, counter="approx_min_k"):
        before = approx_topk.LAUNCHES[counter]
        got = fn()
        torch.cuda.synchronize()
        if approx_topk.LAUNCHES[counter] != before + 1:
            raise AssertionError(f"{name}: not one launch of the kernel")
        return got

    f64 = [(f"f64/{c[0]}", *c[1:]) for c in APPROX_CASES if c[0] in APPROX_F64_CASES]
    for case, rows, n, k, aggregate, rt in APPROX_CASES + tuple(f64):
        dt = np.float64 if case.startswith("f64/") else np.float32
        size = 8 if dt == np.float64 else 4
        d = torch.from_numpy(approx_rows(rng, case.removeprefix("f64/"), rows, n,
                                         dt)).to(device)
        L = approx_topk.reduction_width(n, k, rt)
        width = k if aggregate else L
        call = lambda: approx_topk.approx_min_k(d, k, rt, aggregate)  # noqa: E731
        plain = lambda: approx_topk.approx_min_k_reference(d, k, rt, aggregate)  # noqa: E731
        topk = lambda: torch.topk(d, k, dim=-1, largest=False)  # noqa: E731
        counter = "approx_min_k[f64]" if size == 8 else "approx_min_k"
        (gv, gp), (wv, wp) = launched_once(f"approx_min_k/{case}", call, counter), plain()
        bits = torch.int64 if size == 8 else torch.int32
        same = torch.equal(gp, wp) and torch.equal(gv.view(bits), wv.view(bits))
        topk()
        t_bytes = (size * rows * n + (size + 8.0) * rows * width) / PEAK_BYTES_PER_S
        t_ops = float(rows * n) / PEAK_FP32_FLOPS
        entry = {"rows": rows, "n": n, "k": k, "aggregate_to_topk": aggregate,
                 "recall_target": rt, "L": L, "out": width, "dtype": str(d.dtype),
                 **approx_entry(call, plain, topk, same, gv, wv,
                                approx_topk.launch_plan(rows, n, L, width, d.dtype),
                                t_bytes, t_ops, reps=5 if size == 8 else 20)}
        emit({"phase": "approx_kernel", "case": case, **entry})
        if not same:
            raise AssertionError(f"approx_min_k/{case}: differs from its plain version")
        out[case] = entry
        del d, gv, gp, wv, wp

    f64 = [(f"f64/{c[0]}", *c[1:]) for c in FUSED_CASES if c[0] in FUSED_F64_CASES]
    for case, rows, c, flat, method in FUSED_CASES + tuple(f64):
        dt = np.float64 if case.startswith("f64/") else np.float32
        size = 8 if dt == np.float64 else 4
        d = torch.from_numpy(approx_rows(rng, case.removeprefix("f64/"), rows, c,
                                         dt)).to(device)
        ids = torch.from_numpy(rng.permutation(c).astype(np.int32)).to(device)
        if not flat:  # the (q, c) ids of a carry || tile or of the survivors
            ids = ids[None].repeat(rows, 1) + torch.arange(
                rows, dtype=torch.int32, device=device)[:, None] * c
        n_pad = -(-c // approx_topk.LANES) * approx_topk.LANES
        asked = 4 * K if method == "approx-rerank" else K
        L = approx_topk.reduction_width(n_pad, asked, RECALL_TARGET)
        call = lambda: smallest_k(d, ids, K, method=method)  # noqa: E731
        plain = lambda: approx_topk.approx_smallest_k_reference(  # noqa: E731
            d, ids, K, method, RECALL_TARGET)
        topk = lambda: torch.topk(d, K, dim=-1, largest=False)  # noqa: E731
        counter = "approx_min_k[f64]" if size == 8 else "approx_min_k"
        (gv, gi), (wv, wi) = (launched_once(f"approx_smallest_k/{case}", call, counter),
                              plain())
        bits = torch.int64 if size == 8 else torch.int32
        same = torch.equal(gi, wi) and torch.equal(gv.view(bits), wv.view(bits))
        topk()
        # the rows once, the K ids a row gathers, the (value, id) outputs
        t_bytes = (size * rows * c + 4.0 * rows * K + (size + 4.0) * rows * K) \
            / PEAK_BYTES_PER_S
        t_ops = float(rows * c) / PEAK_FP32_FLOPS
        entry = {"rows": rows, "c": c, "n_pad": n_pad, "ids": "(c,)" if flat else "(q, c)",
                 "method": method, "k": K, "L": L, "out": min(K, L), "dtype": str(d.dtype),
                 **approx_entry(call, plain, topk, same, gv, wv,
                                approx_topk.launch_plan(rows, n_pad, L, min(K, L),
                                                        d.dtype),
                                t_bytes, t_ops, reps=5 if size == 8 else 20)}
        emit({"phase": "approx_kernel", "case": f"fused/{case}", **entry})
        if not same:
            raise AssertionError(f"approx_smallest_k/{case}: differs from the plain chain")
        out[f"fused/{case}"] = entry
        del d, ids, gv, gi, wv, wi
    emit({"phase": "approx_host", **approx_host_parts(device)})
    return out


def approx_host_parts(device) -> dict:
    """Host microseconds a call (time.perf_counter_ns over HOST_CALLS calls
    that do not synchronize) at the serial tile (1024 x 2048, (c,) ids,
    approx, k 10): the whole smallest_k call, the fused wrapper, and its
    parts (the device context the wrapper now skips on the current card,
    current_stream(), the raw stream handle, the two output allocations,
    the cached plan, the ctypes call alone with its arguments ready, the
    data_ptr reads); and the chain smallest_k ran before the fused form,
    re-enacted around today's kernel: the lane padding (two torch.cat of
    new_full), .contiguous(), the device context, the wrapper of the
    unfused kernel (its two allocations, stream, ctypes call), the id
    gather, isinf and where."""
    import torch

    from mpi_knn_tpu_torch.ops import approx_topk
    from mpi_knn_tpu_torch.ops.topk import smallest_k
    from mpi_knn_tpu_torch.types import INVALID_ID

    rng = np.random.default_rng(5)
    q, c = 1024, 2048
    d = torch.from_numpy(rng.standard_normal((q, c)).astype(np.float32) ** 2).to(device)
    ids = torch.arange(c, dtype=torch.int32, device=device)
    idx = d.device.index
    L = approx_topk.reduction_width(c, K, RECALL_TARGET)
    plan = approx_topk.launch_plan(q, c, L, K)
    vals = torch.empty((q, K), dtype=torch.float32, device=device)
    out_ids = torch.empty((q, K), dtype=torch.int32, device=device)
    lib = approx_topk._lib()
    stream = torch.cuda.current_stream(idx).cuda_stream
    args = (d.data_ptr(), c, q, c, c, L, K, approx_topk.REGIMES.index(plan["regime"]),
            plan["G"], plan["chunk"], plan["chunks"], plan["shared_bytes"], None, 0,
            vals.data_ptr(), None, ids.data_ptr(), 0, out_ids.data_ptr(), stream)

    def context():
        with torch.cuda.device(d.device):
            pass

    def old_chain():
        dd, ii = d, ids[None, :].expand(q, c)
        pad = -c % approx_topk.LANES
        if pad:
            dd = torch.cat([dd, dd.new_full((q, pad), float("inf"))], -1)
            ii = torch.cat([ii, ii.new_full((q, pad), INVALID_ID)], -1)
        with torch.cuda.device(d.device):
            v, p = approx_topk.approx_min_k(dd.contiguous(), K, RECALL_TARGET)
        got = torch.gather(ii, -1, p)
        return v, torch.where(torch.isinf(v), INVALID_ID, got)

    parts = {
        "smallest_k": lambda: smallest_k(d, ids, K, method="approx"),
        "approx_smallest_k": lambda: approx_topk.approx_smallest_k(d, ids, K, "approx"),
        "old_chain_reenacted": old_chain,
        "device_context": context,
        "current_stream": lambda: torch.cuda.current_stream(idx).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "current_device": torch.cuda.current_device,
        "two_allocations": lambda: (
            torch.empty((q, K), dtype=torch.float32, device=device),
            torch.empty((q, K), dtype=torch.int32, device=device)),
        "launch_plan_cached": lambda: approx_topk.launch_plan(q, c, L, K),
        "ctypes_call": lambda: lib.approx_min_k_launch(*args),
        "four_data_ptr": lambda: (d.data_ptr(), ids.data_ptr(), vals.data_ptr(),
                                  out_ids.data_ptr()),
    }
    us = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(HOST_CALLS):
            fn()
        us[name] = (time.perf_counter_ns() - t0) / 1e3 / HOST_CALLS
        torch.cuda.synchronize()
    return {"rows": q, "c": c, "method": "approx", "k": K, "calls": HOST_CALLS,
            "us_per_call": us}


def run_cli_phase(device, X, y) -> dict:
    """The C reference's own run through ``cli.main`` in process: the
    60000x784 corpus written as an uncompressed MAT v5 file (train_X
    float64, train_labels 1-based; a small compressed one covers the zlib
    path), then the exact pallas run (its ids bitwise those of all_knn on
    the array in memory, its matches equal), --svd 64 (eigenvalues against
    an f64 numpy eigh of the f64 Gram; recall against serial), the exact
    serial twolevel run, the three approximate methods on serial twolevel,
    serial stream and pallas tiles
    with --recall-vs-serial (the bin-minimum kernel's launches equal to the
    tiles its path reduces), and query mode at SIFT1M's shape from .fvecs
    files (its saved ids equal all_knn's). Each run with the launch counts
    set to 0 just before it and read just after. Returns the approximate
    kernel's launches on its main path (serial twolevel approx)."""
    import torch

    from mpi_knn_tpu_torch import all_knn, cli, knn_classify
    from mpi_knn_tpu_torch.data import matfile, vecs
    from mpi_knn_tpu_torch.data.svd import gram_eigh
    from mpi_knn_tpu_torch.data.synthetic import make_sift_like

    tmp = tempfile.mkdtemp(prefix="run_cli_")
    try:
        mat, small = f"{tmp}/mnist_train.mat", f"{tmp}/small.mat"
        t0 = time.perf_counter()
        matfile.write_mat(mat, {"train_X": X.astype(np.float64),
                                "train_labels": (y + 1).astype(np.float64)},
                          compress=False)
        write_s = time.perf_counter() - t0
        matfile.write_mat(small, {"train_X": X[:2000].astype(np.float64),
                                  "train_labels": (y[:2000] + 1).astype(np.float64)})
        t0 = time.perf_counter()
        Xl, yl = matfile.load_corpus_mat(mat)
        load_s = time.perf_counter() - t0
        Xs, ys = matfile.load_corpus_mat(small)
        same = (np.array_equal(Xl, X) and np.array_equal(yl, y)
                and np.array_equal(Xs, X[:2000]) and np.array_equal(ys, y[:2000]))
        reader = matfile.reader_name()
        emit({"phase": "run_cli", "step": "load", "file_bytes": os.path.getsize(mat),
              "write_s": write_s, "load_s": load_s, "mat_reader": reader,
              "loaded_equals_written": same})
        if not same:
            raise AssertionError("the loaded .mat differs from the written arrays")
        del Xl, yl, Xs, ys

        def run(label, argv):
            report, nn = f"{tmp}/{len(os.listdir(tmp))}.json", f"{tmp}/nn.npz"
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main([*argv, "--k", str(K), "-q", "--report", report,
                           "--save-neighbors", nn])
            sync_all()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts().items() if v}
            if rc != 0:
                raise AssertionError(f"run_cli/{label}: exit {rc}")
            with open(report) as f:
                doc = json.load(f)
            saved = dict(np.load(nn))
            emit({"phase": "run_cli", "step": label, "argv": argv, "wall_s": wall,
                  "phase_seconds": doc["phase_seconds"], "shape": doc["shape"],
                  "matches": doc["matches"], "recall_vs_serial": doc["recall_vs_baseline"],
                  "recall_sample": doc["notes"].get("recall_sample"),
                  "mat_reader": doc["notes"].get("mat_reader"), "launches": counts,
                  "approx_min_k_launches": counts.get("approx_min_k", 0)})
            return doc, saved, counts

        doc, saved, _ = run("mat/pallas/exact", ["--data", mat, "--loo", "--backend", "pallas"])
        want = all_knn(X, k=K, backend="pallas", device=device)
        want_matches = int(knn_classify(want, y).matches(y))
        same = np.array_equal(saved["ids"], want.ids.cpu().numpy())
        emit({"phase": "run_cli", "step": "mat_vs_all_knn", "ids_bitwise_equal": same,
              "matches": doc["matches"], "all_knn_matches": want_matches})
        if not same or doc["matches"] != want_matches:
            raise AssertionError("the .mat run differs from all_knn on the array in memory")
        del want

        doc, _, _ = run("mat/svd64/pallas/exact", ["--data", mat, "--loo", "--svd", "64",
                                                   "--backend", "pallas", "--recall-vs-serial"])
        vals, _, _ = gram_eigh(torch.from_numpy(X).to(device))
        Xc = X.astype(np.float64) - X.astype(np.float64).mean(0)
        want_vals = np.linalg.eigvalsh(Xc.T @ Xc)[::-1][:64]
        rel = float(np.max(np.abs(vals[:64].cpu().numpy() - want_vals) / want_vals))
        emit({"phase": "run_cli", "step": "svd_eigenvalues", "top": 64,
              "max_rel_err_vs_f64": rel, "largest": float(want_vals[0]),
              "smallest_kept": float(want_vals[-1])})
        if rel > 1e-4 or doc["recall_vs_baseline"] < RECALL_GATE:
            raise AssertionError(f"svd: eigenvalue error {rel}, recall {doc['recall_vs_baseline']}")
        del Xc, vals

        # the approximate kernel launches once per (query tile, corpus tile)
        # on serial (59 x 30 at 1024 x 2048 tiles), and on pallas tiles once
        # per call (the cross-tile merge of 30 x k survivors), where the
        # method reduces: over k columns (approx), over 4k (approx-rerank);
        # bf16 never
        tiles = -(-M_FULL // 1024) * -(-M_FULL // 2048)
        merged = -(-M_FULL // C_TILE) * K
        # recall gates: "approx" at its recall_target; "approx-rerank" at
        # 0.999 where the reduction runs once over a tile's columns, and at
        # STREAM_RERANK_GATE over every row on the stream schedule, which
        # reduces carry || tile at each of its 30 steps, so a kept
        # neighbour meets a bin-mate from each new tile; "bf16" at 0.999
        gates = {"approx": RECALL_TARGET, "approx-rerank": RECALL_GATE, "bf16": RECALL_GATE}
        # the exact serial run beside them, for the knn phase's seconds
        run("serial/twolevel/exact", ["--data", mat, "--loo", "--backend", "serial"])
        launches = None
        for method, method_gate in gates.items():
            asked = 4 * K if method == "approx-rerank" else K
            for path, flags, expect in (
                    ("serial/twolevel", ["--backend", "serial"], tiles),
                    ("serial/stream", ["--backend", "serial", "--merge-schedule", "stream"], tiles),
                    ("pallas/tiles", ["--backend", "pallas"], int(merged > asked))):
                stream_rerank = (path, method) == ("serial/stream", "approx-rerank")
                sample = ["--recall-sample", "0"] if stream_rerank else []
                doc, _, counts = run(f"{path}/{method}", ["--data", mat, "--loo", *flags,
                                                          "--topk-method", method,
                                                          "--recall-vs-serial", *sample])
                got = counts.get("approx_min_k", 0)
                want_n = 0 if method == "bf16" else expect
                gate = STREAM_RERANK_GATE if stream_rerank else method_gate
                if doc["recall_vs_baseline"] < gate or got != want_n:
                    raise AssertionError(
                        f"{path}/{method}: recall {doc['recall_vs_baseline']} (gate {gate}), "
                        f"approx_min_k launches {got} (expected {want_n})")
                if (path, method) == ("serial/twolevel", "approx"):
                    launches = got

        base, qf = f"{tmp}/sift_base.fvecs", f"{tmp}/sift_query.fvecs"
        t0 = time.perf_counter()
        B, Q = make_sift_like(1_000_000, seed=0), make_sift_like(10_000, seed=1)
        vecs.write_vecs(base, B)
        vecs.write_vecs(qf, Q)
        emit({"phase": "run_cli", "step": "sift_files", "base_bytes": os.path.getsize(base),
              "make_and_write_s": time.perf_counter() - t0})
        doc, saved, _ = run("sift1m/query/pallas", ["--data", base, "--queries", qf,
                                                    "--backend", "pallas"])
        want = all_knn(B, queries=Q, k=K, backend="pallas", device=device)
        same = np.array_equal(saved["ids"], want.ids.cpu().numpy())
        emit({"phase": "run_cli", "step": "sift_vs_all_knn", "queries": len(Q),
              "corpus": list(B.shape), "ids_bitwise_equal": same,
              "vote": "predictions" in saved})
        if not same or doc["shape"] != [1_000_000, 128] or "predictions" in saved:
            raise AssertionError("the SIFT query run differs from all_knn")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the clustered (IVF) index at the README's deployment -----------------
# build-index --data sift:100000 --partitions 256; query --index-load
# --synthetic 10000 --batch 512 (README.md:517-520): k = 10, recall_target
# 0.95, 25 Lloyd rounds from kmeans++
IVF_M = 100000
IVF_P = 256
IVF_QUERIES = 10000
IVF_BATCH = 512
IVF_ORACLE_ROWS = 256
IVF_SUBSET = 16384  # rows of the nprobe = partitions check against serial
# (store, recall@10 bar of the JAX package's own test, queries its pass
# searches): tests/test_ivf.py:451-486, tests/test_quant.py:428-468 and
# :326-342
IVF_STORES = (("float32", 0.95, IVF_QUERIES), ("int4", 0.80, IVF_QUERIES),
              ("int8", 0.95, IVF_QUERIES))
IVF_STAGES = ("score", "gather", "dequantize", "products", "selection")


def ivf_data():
    """The deployment's corpus (``sift:100000``) and 10000 held-out rows of
    its own distribution: the rows ``make_sift_like`` draws past the corpus
    (its first chunk is the corpus, bit for bit). The CLI's ``--synthetic``
    stream is uniform over the value range, far from every cluster, which
    no clustered index serves at its tuned recall; it is timed through the
    CLI and not gated."""
    from mpi_knn_tpu_torch.data.synthetic import make_sift_like

    A = make_sift_like(IVF_M + IVF_QUERIES, seed=0, chunk=IVF_M)
    X, Q = A[:IVF_M], A[IVF_M:]
    if not np.array_equal(X, make_sift_like(IVF_M, seed=0)):
        raise AssertionError("ivf: the corpus is not sift:100000")
    return X, Q


def tie_recall(got, od, oi, k: int = K) -> float:
    """Tie-aware recall@k (``tests/oracle.py::recall_against_oracle``): a
    returned id is a hit when its oracle distance is within the oracle's
    k-th."""
    total, rows = 0.0, 0
    for r in range(got.shape[0]):
        valid = oi[r] >= 0
        n_valid = min(k, int(valid.sum()))
        if n_valid == 0:
            continue
        want = set(oi[r][valid & (od[r] <= od[r, n_valid - 1])].tolist())
        total += len(set(got[r, :k].tolist()) & want) / n_valid
        rows += 1
    return total / max(rows, 1)


def ivf_oracle(X, Q, device, self_rows=None):
    """f64 on the card: each query's K + 5 nearest corpus rows, zero
    distances excluded and, for corpus rows, the row itself (the JAX
    package's gate). Host (dists, ids)."""
    import torch

    X64 = torch.from_numpy(X).to(device, torch.float64)
    q64 = torch.from_numpy(Q).to(device, torch.float64)
    d = (q64 * q64).sum(1)[:, None] + (X64 * X64).sum(1)[None] - 2.0 * q64 @ X64.T
    d[d <= 1e-9] = float("inf")
    if self_rows is not None:
        d[torch.arange(len(self_rows)), torch.from_numpy(self_rows)] = float("inf")
    vals, ids = torch.sort(d, dim=1, stable=True)
    return vals[:, :K + 5].cpu().numpy(), ids[:, :K + 5].cpu().numpy()


def ivf_split(index, q_tiles, qid_tiles, cfg):
    """The one-shot search's stages tile by tile, each between CUDA events
    (the exact finish's row chunks as ``finish_candidates`` cuts them):
    ms a stage summed over the tiles, each beside its byte bound at
    PEAK_BYTES_PER_S (every input read once, every output written once),
    and the (q_pad, k) results."""
    import torch

    from mpi_knn_tpu_torch.ivf.search import finish_rows, gather_probes, score_centroids
    from mpi_knn_tpu_torch.ops.quant import dequantize_rows
    from mpi_knn_tpu_torch.ops.rerank import exact_candidate_dists
    from mpi_knn_tpu_torch.ops.topk import smallest_k

    def ev():
        return torch.cuda.Event(enable_timing=True)

    spans = {s: [] for s in IVF_STAGES}
    nbytes = dict.fromkeys(IVF_STAGES, 0)
    out_d, out_i = [], []
    d, k = index.dim, cfg.k
    at_rest = index.buckets.shape[-1] * index.buckets.element_size()
    for q_x, q_ids in zip(q_tiles, qid_tiles):
        e = [ev() for _ in range(4)]
        e[0].record()
        q_sq, probe = score_centroids(q_x, index.centroids, index.centroid_sqs,
                                      cfg.nprobe)
        e[1].record()
        rows, ids, sqs, scl = gather_probes(probe, index.buckets, index.bucket_ids,
                                            index.bucket_sqs, index.bucket_scales)
        e[2].record()
        if scl is not None:
            rows = dequantize_rows(rows, scl, cfg.dtype, d)
        rows = rows.to(torch.float32)
        e[3].record()
        spans["score"].append((e[0], e[1]))
        spans["gather"].append((e[1], e[2]))
        spans["dequantize"].append((e[2], e[3]))
        q, v = ids.shape
        nbytes["score"] += q * d * 4 + index.centroids.numel() * 4 + q * cfg.nprobe * 8
        side = 4 * (2 + (scl is not None))  # ids, norms (and scales) a slot
        nbytes["gather"] += 2 * q * v * (at_rest + side)
        if scl is not None:
            nbytes["dequantize"] += q * v * (at_rest + 4 + 4 * d)
        nbytes["products"] += q * v * (4 * d + 4 + 4) + q * d * 4
        nbytes["selection"] += q * v * 8 + q * k * 8
        step = finish_rows(v, d)
        parts = []
        for s in range(0, q, step):
            a, b, c = ev(), ev(), ev()
            a.record()
            dist = exact_candidate_dists(q_x[s:s + step], q_ids[s:s + step],
                                         rows[s:s + step], ids[s:s + step],
                                         exclude_self=cfg.exclude_self,
                                         exclude_zero=cfg.exclude_zero,
                                         zero_eps=cfg.zero_eps)
            b.record()
            parts.append(smallest_k(dist, ids[s:s + step], k, method="exact"))
            c.record()
            spans["products"].append((a, b))
            spans["selection"].append((b, c))
        out_d.append(torch.cat([p[0] for p in parts]))
        out_i.append(torch.cat([p[1] for p in parts]))
    torch.cuda.synchronize()
    split = {s: {"ms": sum(a.elapsed_time(b) for a, b in spans[s]),
                 "bound_ms": 1e3 * nbytes[s] / PEAK_BYTES_PER_S, "bytes": nbytes[s]}
             for s in IVF_STAGES}
    return split, torch.cat(out_d), torch.cat(out_i)


def ivf_serve(index, Q, device) -> dict:
    """Q in IVF_BATCH-row batches through ServeSession (the index's config:
    bucket base 1024, depth 2): one checked pass (returned), then one timed
    window."""
    from mpi_knn_tpu_torch.serve import ServeSession

    batches = [Q[s:s + IVF_BATCH] for s in range(0, len(Q), IVF_BATCH)]
    sess = ServeSession(index, device=device)
    warm = sess.warm(sorted({len(b) for b in batches}))
    checked = list(sess.stream(batches))
    sess.reset_stats()
    t0 = time.perf_counter()
    list(sess.stream(batches))
    wall = time.perf_counter() - t0
    lat = 1e3 * np.asarray(sess.latencies)
    return {"checked": checked, "qps": len(Q) / wall, "wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batches": len(batches), "entries_built": warm["built"]}


def ivf_phase(device) -> dict:
    """The clustered index at the README's deployment (``IVF_*``): per store
    (float32, int4, int8) the build (seconds by stage; nprobe tuned to
    recall 0.95 against the full scan; bucket_cap, resident bytes, probe
    bytes a row; every resident tensor on the card), the one-shot search
    of the held-out queries (ms, host and device input, median of 3 after
    a warm-up) with its stages by CUDA events beside their byte bounds,
    recall@10 against an f64 oracle on IVF_ORACLE_ROWS sampled queries at
    the JAX package's bar for the store, and serving in IVF_BATCH-row
    batches (q/s, p50, p99; every batch bit for bit the one-shot search's
    rows). On the float32 store also: k-means run again gives the index's
    centroids bit for bit; saved, loaded with mmap and searched again, the
    same ids and distances; the query CLI's ``--index-load`` run at the
    deployment's flags (its ``--synthetic`` stream). Then nprobe =
    partitions on an IVF_SUBSET-row index against the serial ``all_knn``:
    ids tie-aware >= 0.999, distances within 1e-5. The launch counts are
    set to 0 before and read after: no kernel of the port runs on this
    path (no Pallas site lies on the JAX package's)."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, all_knn, cli
    from mpi_knn_tpu_torch.ivf import (
        build_ivf_index,
        kmeans,
        load_ivf_index,
        save_ivf_index,
        search_ivf,
    )
    from mpi_knn_tpu_torch.ivf.search import prepare_query_tiles

    t_phase = time.perf_counter()
    X, Q = ivf_data()
    sample = np.linspace(0, IVF_QUERIES - 1, IVF_ORACLE_ROWS).astype(np.int64)
    od, oi = ivf_oracle(X, Q[sample], device)
    # the JAX package's gate form beside it: corpus rows with their ids
    # (seeded, apart from the tuner's linspace sample)
    own = np.sort(np.random.default_rng(7).choice(IVF_M, IVF_ORACLE_ROWS,
                                                  replace=False))
    cd, ci = ivf_oracle(X, X[own], device, self_rows=own)
    reset_counts()
    results = {}
    for dtype, bar, nq in IVF_STORES:
        if nq < IVF_QUERIES:
            emit({"phase": "ivf_cut", "store": dtype, "queries": nq,
                  "of": IVF_QUERIES})
        Qn = Q[:nq]
        t0 = time.perf_counter()
        index = build_ivf_index(X, KNNConfig(k=K, partitions=IVF_P, dtype=dtype),
                                device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        resident = {name: str(t.device) for name, t in (
            ("centroids", index.centroids), ("centroid_sqs", index.centroid_sqs),
            ("buckets", index.buckets), ("bucket_ids", index.bucket_ids),
            ("bucket_sqs", index.bucket_sqs), ("bucket_scales", index.bucket_scales))
            if t is not None}
        if any(not d.startswith("cuda") for d in resident.values()):
            raise AssertionError(f"ivf {dtype}: resident tensors off the card: {resident}")
        emit({"phase": "ivf_build", "store": dtype, "m": IVF_M, "d": X.shape[1],
              "partitions": IVF_P, "seconds": build_s,
              "seconds_by_stage": index.build_seconds, "nprobe": index.nprobe,
              "tuned_recall": index.tuned_recall, "bucket_cap": index.bucket_cap,
              "resident_bytes": index.nbytes_resident,
              "probe_bytes_per_row": index.probe_bytes,
              "probe_fraction": index.nprobe / IVF_P, "resident_on": resident})

        # one shot: host input (centering, padding, copy) and device input
        Qd = torch.from_numpy(Qn).to(device)
        d0, i0 = search_ivf(index, Qn, device=device)  # warm-up, the reference
        times = {"host": [], "device": []}
        for _ in range(3):
            for form, q in (("host", Qn), ("device", Qd)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d1, i1 = search_ivf(index, q, device=device)
                torch.cuda.synchronize()
                times[form].append(1e3 * (time.perf_counter() - t0))
                if not (torch.equal(d1, d0) and torch.equal(i1, i0)):
                    raise AssertionError(f"ivf {dtype}: a {form}-input search differs")
        cfg = index.compatible_cfg(index.cfg)
        q_tiles, qid_tiles, q_pad, q_tile = prepare_query_tiles(index, Qn, None, cfg)
        split, sd, si = ivf_split(index, q_tiles, qid_tiles, cfg)
        if not (torch.equal(sd[:nq], d0) and torch.equal(si[:nq], i0)):
            raise AssertionError(f"ivf {dtype}: the staged run differs from the search")
        got = i0.cpu().numpy()
        rec = tie_recall(got[sample[sample < nq]], od[sample < nq], oi[sample < nq])
        _, own_i = search_ivf(index, X[own], query_ids=own, device=device)
        rec_rows = tie_recall(own_i.cpu().numpy(), cd, ci)
        emit({"phase": "ivf_search", "store": dtype, "queries": nq, "k": K,
              "nprobe": cfg.nprobe, "q_tile": q_tile, "q_pad": q_pad,
              "ms_host_input": statistics.median(times["host"]),
              "ms_device_input": statistics.median(times["device"]),
              "ms_runs": times, "stages": split,
              "stages_ms_sum": sum(s["ms"] for s in split.values()),
              "stages_bound_ms_sum": sum(s["bound_ms"] for s in split.values()),
              "recall_at_10": rec, "recall_bar": bar,
              "recall_at_10_corpus_rows": rec_rows,
              "finite": bool(torch.isfinite(d0).all())})
        if rec < bar or not torch.isfinite(d0).all() or (i0 < 0).any():
            raise AssertionError(f"ivf {dtype}: recall@10 {rec} < {bar}, or "
                                 "non-finite results")

        served = ivf_serve(index, Qn, device)
        got_d = np.concatenate([b.dists for b in served["checked"]])
        got_i = np.concatenate([b.ids for b in served["checked"]])
        equal = (np.array_equal(got_d, d0.cpu().numpy())
                 and np.array_equal(got_i, i0.cpu().numpy()))
        emit({"phase": "ivf_serve", "store": dtype, "batch": IVF_BATCH,
              "bucket": cfg.query_bucket, "depth": cfg.dispatch_depth,
              **{k_: v for k_, v in served.items() if k_ != "checked"},
              "batches_equal_one_shot": equal,
              "peak_hbm_bytes": torch.cuda.max_memory_allocated(device)})
        if not equal:
            raise AssertionError(f"ivf {dtype}: a served batch differs from "
                                 "the one-shot search")
        results[dtype] = {"build_s": build_s, "nprobe": index.nprobe,
                          "recall": rec, "qps": served["qps"]}

        if dtype == "float32":
            again = kmeans(torch.from_numpy(X - index.mu).to(device, torch.float32), IVF_P,
                           iters=index.cfg.kmeans_iters, seed=index.cfg.ivf_seed,
                           device=device)
            if not torch.equal(again.centroids, index.centroids):
                raise AssertionError("ivf: k-means run twice gives other bits")
            with tempfile.TemporaryDirectory() as tmp:
                path = save_ivf_index(index, os.path.join(tmp, "sift.ivf.npz"))
                size = os.path.getsize(path)
                t0 = time.perf_counter()
                loaded = load_ivf_index(path, mmap=True, device=device)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                d2, i2 = search_ivf(loaded, Qn, device=device)
                same = torch.equal(d2, d0) and torch.equal(i2, i0)
                report = os.path.join(tmp, "query.json")
                rc = cli.main(["query", "--data", f"sift:{IVF_M}", "--index-load",
                               path, "--synthetic", str(IVF_QUERIES), "--batch",
                               str(IVF_BATCH), "--k", str(K), "-q",
                               "--report", report])
                with open(report) as f:
                    summary = json.load(f)
            emit({"phase": "ivf_save_load", "npz_bytes": size, "load_s": load_s,
                  "search_equal": same, "kmeans_twice_equal": True})
            emit({"phase": "ivf_query_cli", "rc": rc, "argv": (
                f"query --data sift:{IVF_M} --index-load sift.ivf.npz "
                f"--synthetic {IVF_QUERIES} --batch {IVF_BATCH} --k {K}"),
                **{k_: summary.get(k_) for k_ in (
                    "queries", "batches", "throughput_qps", "latency_p50_ms",
                    "latency_p99_ms", "index_build_s", "nprobe", "at_rest",
                    "executables_compiled")}})
            if not same or rc != 0 or summary.get("queries") != IVF_QUERIES:
                raise AssertionError("ivf: the saved index searched other ids, "
                                     "or the query CLI failed")
        del index
        torch.cuda.empty_cache()

    # nprobe = partitions: the full scan against the serial backend
    Xs = X[:IVF_SUBSET]
    rows = np.linspace(0, IVF_SUBSET - 1, IVF_ORACLE_ROWS).astype(np.int64)
    full = build_ivf_index(Xs, KNNConfig(k=K, partitions=IVF_P, nprobe=IVF_P),
                           device=device)
    gd, gi = search_ivf(full, Xs[rows], query_ids=rows, device=device)
    want = all_knn(Xs, queries=Xs[rows], query_ids=rows,
                   config=KNNConfig(k=K, backend="serial"), device=device)
    wd, wi = want.dists.cpu().numpy(), want.ids.cpu().numpy()
    agree = tie_recall(gi.cpu().numpy(), wd, wi)
    err = float(np.max(np.abs(gd.cpu().numpy() - wd)
                       / np.maximum(1.0, np.abs(wd))))
    close = bool(np.allclose(gd.cpu().numpy(), wd, rtol=1e-5, atol=1e-5))
    emit({"phase": "ivf_full_scan", "m": IVF_SUBSET, "partitions": IVF_P,
          "ids_agree": agree, "max_rel_dist_diff": err, "within_1e-5": close})
    if agree < 0.999 or not close:
        raise AssertionError(f"ivf: nprobe = partitions disagrees with serial "
                             f"(ids {agree}, distances within 1e-5: {close})")
    counts = {name: n for name, n in read_counts().items() if n}
    emit({"phase": "ivf_launches", "launches": counts,
          "seconds": time.perf_counter() - t_phase, "stores": results})
    if counts:
        raise AssertionError(f"ivf: kernels launched on the IVF path: {counts}")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from mpi_knn_tpu_torch import KNNClassifier, KNNConfig, all_knn, knn_classify
    from mpi_knn_tpu_torch.backends import ring
    from mpi_knn_tpu_torch.backends.serial import all_knn_serial
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
    from mpi_knn_tpu_torch.ops import _build, fused_knn, fused_ring, fused_rotation
    from mpi_knn_tpu_torch.ops.topk import init_topk
    from mpi_knn_tpu_torch.ops.quant import dequantize_rows, quantize_rows
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh
    from mpi_knn_tpu_torch.parallel.partition import (
        make_global_ids,
        pad_rows_any,
        pad_to_multiple,
    )

    device = torch.device("cuda", 0)
    marks = [("start", time.perf_counter())]

    def mark(name):
        """One line of the seconds since the previous mark."""
        marks.append((name, time.perf_counter()))
        emit({"phase": "phase_seconds", "name": name,
              "seconds": marks[-1][1] - marks[-2][1]})

    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the exact policy needs full f32")
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # the exact wgmma tile at the other promotion intervals (k-steps of 8;
    # 0: none), built beside the sources for the exact_error_interval phase
    intervals = {f"KNN_WGMMA_PROMOTE={n}": 8 * n for n in (0, 1, 4)}
    info = _build.build_all(variants=[("fused_knn", (d,)) for d in intervals])
    for label, entry in info.items():
        print(entry["log"], file=sys.stderr)
        name, *defines = label.split(" ")
        emit({"phase": "build", "source": f"csrc/{name}.cu", "defines": defines,
              "seconds": entry["seconds"], "cached": entry["log"] == "cached"})

    mark("build")
    # ---- every kernel: tensor-core instructions and resources -------------
    mma = {src: sass_mma_counts(_build._lib_path(src)) for src in _build.SOURCES}
    emit({"phase": "sass", "mma_by_function": mma})
    # kernel mode -> the functions of its library whose SASS must hold the
    # instruction: wgmma (HGMMA) for the exact K1/K2, K4's f32 form and
    # their prologues, mma.sync (HMMA) for the rest
    kernel_fns = {"fused_knn_tiles": [("fused_knn_tiles_kernel", "HGMMA")],
                  "fused_knn_sweep": [("fused_knn_sweep_kernel", "HGMMA")],
                  "stage_tf32_split": [("stage_split_kernel", "HGMMA")],
                  "fused_knn_tiles[compress]": [("fused_knn_tiles_compress_kernel", "HMMA")],
                  "fused_knn_sweep[compress]": [("fused_knn_sweep_compress_kernel", "HGMMA")],
                  "fused_block_merge[exact]": [("block_merge_exact_kernel", "HMMA")],
                  "fused_block_merge[compress]": [("block_merge_compress_kernel", "HMMA")],
                  "fused_round_dma": [("round_dma_kernel_wgmma", "HGMMA"),
                                      ("round_dma_kernelIL", "HMMA")],
                  "stage_tf32_split[ring]": [("stage_split_kernel", "HGMMA")],
                  "fused_rotation_grid": [("rotation_grid_kernel", "HMMA")]}
    # the "default" / "high" forms: the mma.sync tile on Bf16x1F32 / Bf16x3
    policy = {"default": "Bf16x1F32", "high": "Bf16x3"}
    for p in PRECISIONS:
        for base, fn in (("fused_knn_tiles", "fused_knn_mma_kernel"),
                         ("fused_knn_sweep", "fused_knn_mma_kernel"),
                         ("fused_block_merge", "block_merge_exact_kernel"),
                         ("fused_round_dma", "round_dma_kernelIL"),
                         ("fused_rotation_grid", "rotation_grid_kernel")):
            kernel_fns[f"{base}[{p}]"] = [(fn, "HMMA", policy[p])]
    kernel_fns["stage_norms"] = [("stage_tf32_kernel", "HMMA", None)]
    for name, checks in kernel_fns.items():
        lib = mma[source_of(name).removesuffix(".cu")]
        checks = [c if len(c) == 3 else (*c, None) for c in checks]
        if "[default]" in name or "[high]" in name or name == "stage_norms":
            found = {f"{op.lower()}_in_sass[{fn}]": sum(
                v[op] for f, v in lib.items() if fn in f and (pol is None or pol in f))
                for fn, op, pol in checks}
            p = name[name.index("[") + 1:-1] if "[" in name else None
            base = name.split("[")[0]
            if name == "stage_norms":
                info = {}
            elif base.startswith("fused_knn"):
                info = fused_knn.mma_plan(base, 60416, 61440, C_TILE, K, p)
            elif base == "fused_block_merge":
                info = {f"q_local_{ql}": fused_ring.exact_plan(torch.float32, ql, K, p)
                        for ql in (60416, 15360)}
            else:
                which = "round" if base == "fused_round_dma" else "grid"
                info = {f"{n}_ranks_per_card": fused_rotation.ring_kernel_plan(
                    which, torch.float32, n, 15360, K, p) for n in (4, 1)}
            emit({"phase": "kernel_resources", "kernel": name, "k": K, **found, **info})
            for key, n in found.items():
                if n <= 0:
                    raise AssertionError(f"{name}: {key} is 0")
            continue
        checks = [c[:2] for c in checks]
        found = {f"{op.lower()}_in_sass[{fn}]": sum(v[op] for f, v in lib.items() if fn in f)
                 for fn, op in checks}
        kk = OV if "[compress]" in name else K
        if name.startswith("stage_tf32_split"):
            info = {}
        elif name.startswith("fused_knn"):
            info = fused_knn.kernel_info(name, kk)
            if "[compress]" not in name:  # the persistent grid at the main shape
                info["plan"] = fused_knn.exact_plan(name, 60416, 61440, C_TILE, K)
                info["plan"]["sms"] = sms
            elif name == "fused_knn_sweep[compress]":  # its plan, and no mma.sync
                info["hmma_in_sass[fused_knn_sweep_compress_kernel]"] = sum(
                    v["HMMA"] for f, v in lib.items() if "fused_knn_sweep_compress_kernel" in f)
                if info["hmma_in_sass[fused_knn_sweep_compress_kernel]"]:
                    raise AssertionError("K2[c] still holds mma.sync (HMMA) instructions")
                for label, rows in (("main_shape", 60416), ("bucket_1024", 1024),
                                    ("bucket_2048", 2048)):
                    plan = fused_knn.compress_sweep_launch_plan(
                        rows, 61440, M_FULL, kk,
                        fused_knn.compress_sweep_plan(rows, M_FULL, sms)["slices"])
                    emit({"phase": "launch_plan", "kernel": name, "shape": label,
                          "Q": rows, "sms": sms, **plan})
        elif name == "fused_block_merge[compress]":
            info = fused_ring.compress_kernel_info(OV)
        elif name == "fused_block_merge[exact]":  # at the P=1 and shard shapes
            info = {f"q_local_{ql}": fused_ring.exact_plan(torch.float32, ql, K)
                    for ql in (60416, 15360)}
        else:  # one card holding 4 ranks, and one rank per card (4 cards)
            which = "round" if name == "fused_round_dma" else "grid"
            info = {f"{n_local}_ranks_per_card": fused_rotation.ring_kernel_plan(
                which, torch.float32, n_local, 15360, K) for n_local in (4, 1)}
            if which == "round":  # P=1: one rank of 60416 queries
                info["1_rank_p1"] = fused_rotation.ring_kernel_plan(
                    which, torch.float32, 1, 60416, K)
                info["bf16_wire_4_ranks_per_card"] = fused_rotation.ring_kernel_plan(
                    which, torch.bfloat16, 4, 15360, K)
                # the wgmma form's registers per warpgroup role (setmaxnreg)
                info["setmaxnreg"] = sorted({x for f, v in lib.items()
                                             if "round_dma_kernel_wgmma" in f
                                             for x in v["SETMAXREG"]})
            for plan in info.values():
                if isinstance(plan, dict) and (which == "grid" or plan["wgmma_tile"]):
                    plan["waves_per_round"] = plan["items_per_round"] / plan["grid"]
                    last = plan["items_per_round"] % plan["grid"] or plan["grid"]
                    plan["last_wave_fill"] = last / plan["grid"]
        emit({"phase": "kernel_resources", "kernel": name, "k": kk, **found, **info})
        for key, n in found.items():
            if n <= 0:
                raise AssertionError(f"{name}: {key} is 0")

    # ---- the ceiling of the tiles' products: the card's tensor-core rates --
    needed = 2.0 * M_FULL * M_FULL * 784  # the main shape's products, D = 784
    rates = {"tf32_wgmma_m64n128k8": fused_knn.wgmma_rate(device),
             "tf32_m16n8k8": fused_knn.mma_rate(device, True),
             "bf16_m16n8k16": fused_knn.mma_rate(device, False)}
    emit({"phase": "mma_ceiling", "tflops": rates,
          "tf32x3_wgmma_floor_ms_main_shape":
              3 * needed / (rates["tf32_wgmma_m64n128k8"] * 1e12) * 1e3,
          "tf32x3_floor_ms_main_shape": 3 * needed / (rates["tf32_m16n8k8"] * 1e12) * 1e3,
          "bf16x1_floor_ms_main_shape": needed / (rates["bf16_m16n8k16"] * 1e12) * 1e3})

    # ---- the partial top-k reduction (lax.approx_min_k) against its plain
    approx = approx_kernel_phase(device)

    mark("sass_rates_approx")
    # ---- the fused kNN kernels against their plain versions -------------
    knn_modes = {  # mode name -> (wrapper, plain version, compress)
        f"{base}{suffix}": (getattr(fused_knn, base),
                            getattr(fused_knn, base + "_reference"),
                            bool(suffix))
        for suffix in ("", "[compress]")
        for base in ("fused_knn_tiles", "fused_knn_sweep")
    }

    def span_of(name, ct, C):  # the corpus columns one output list covers
        return ct if name.startswith("fused_knn_tiles") else C

    max_err = {}
    for case, qp, cp, m, all_pairs, exact, k, qt, ct in kernel_cases(device):
        self_ids = torch.arange(qp.shape[0], device=device) if all_pairs else None
        for name, (kern, plain, compress) in knn_modes.items():
            kk = min(4 * k, ct) if compress else k
            args = (qp, cp, m, kk, qt, ct)
            kw = dict(all_pairs=all_pairs, compress=compress)
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            err = compare(f"{name}/{case}", got, plain(*args, **kw), qp, cp, m,
                          self_ids, exact, kk, span_of(name, ct, cp.shape[0]),
                          compress=compress)
            max_err[name] = max(max_err.get(name, 0.0), err)

    # ---- kernels alone at the main path's shapes -------------------------
    X, y = make_mnist_like(M_FULL)
    Xc = centered(X)
    Xcd = torch.from_numpy(Xc).to(device)
    # the queries are the padded corpus' first rows, as on the main path
    cp = pad_rows_any(Xc, pad_to_multiple(M_FULL, C_TILE), dtype=torch.float32,
                      device=device)
    qp = cp[:pad_to_multiple(M_FULL, Q_TILE)]
    Q, D = qp.shape
    C = cp.shape[0]
    n_c = C // C_TILE
    rng = np.random.default_rng(2)
    sample = torch.from_numpy(
        np.sort(rng.choice(M_FULL, SAMPLE_ROWS, replace=False))).to(device)
    needed_ops = 2.0 * M_FULL * M_FULL * D  # real queries x real rows

    def bound(ops, nbytes, peak):
        t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_PER_S
        return {"bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def exact_bound(ops, nbytes):
        """The exact tile's bound: three TF32 products of the needed FLOP;
        the FP32 (FFMA) bound of one product beside it."""
        return {**bound(3.0 * ops, nbytes, PEAK_TF32_FLOPS),
                "bound_ffma_ms": bound(ops, nbytes, PEAK_FP32_FLOPS)["bound_ms"]}

    timing = {}
    self_all = torch.arange(Q, device=device)
    staged = (fused_knn.stage_bf16_rows(qp), fused_knn.stage_bf16_rows(cp))
    split = fused_knn._stage_exact(qp, cp)  # qp is cp's first rows: staged once
    for name, (kern, plain, compress) in knn_modes.items():
        kk = OV if compress else K
        args = (qp, cp, M_FULL, kk, Q_TILE, C_TILE)
        kw = dict(compress=compress)
        got, want = kern(*args, **kw), plain(*args, **kw)  # also the warm-ups
        call_ms = cuda_ms(lambda: kern(*args, **kw), reps=3)
        base = name.split("[")[0]
        if compress:  # the kernel alone, on operands staged beforehand
            ms = cuda_ms(lambda: fused_knn.launch_compress(
                base, *staged, M_FULL, kk, C_TILE), reps=3)
        else:
            ms = cuda_ms(lambda: fused_knn.launch_exact(
                base, *split, M_FULL, kk, C_TILE), reps=3)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=3)
        # the exact lists are judged on every row; compress lists are 4x as
        # long, so a sample of rows
        err = compare(f"{name}/mnist60k_main_shape", got, want, qp, cp, M_FULL,
                      self_all, False, kk, span_of(name, C_TILE, C),
                      compress=compress, sample=sample if compress else None)
        max_err[name] = max(max_err[name], err)
        if not compress:  # each row's final k: K1's lists merged as K1's path does
            final = [(fused_knn._select(*t, K) if base == "fused_knn_tiles" else t)
                     for t in (got, want)]
            exact_error(
                name, qp[:M_FULL], cp, *((d[:M_FULL], i[:M_FULL]) for d, i in final),
                strict=True)
        out_slots = (n_c if name.startswith("fused_knn_tiles") else 1) * M_FULL * kk
        nbytes = 4.0 * (2 * M_FULL * D) + 8.0 * out_slots
        timing[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                        **(bound(needed_ops, nbytes, PEAK_BF16_FLOPS) if compress
                           else exact_bound(needed_ops, nbytes))}
        timing[name]["tflops"] = needed_ops / (ms * 1e-3) / 1e12
        emit({"phase": "kernel_time", "kernel": name, "Q": Q, "C": C, "D": D,
              "k": kk, **timing[name]})
        del got, want

    # the exact wgmma tile at the other promotion intervals (measurement
    # builds of K2 and its prologue), on the same inputs: error and time
    stream = torch.cuda.current_stream().cuda_stream
    for define, depth in intervals.items():
        variant = fused_knn.configure(_build.load("fused_knn", (define,)))
        planes = [torch.empty((C, D), dtype=torch.float32, device=device)
                  for _ in range(2)]
        var_norms = torch.empty(C, dtype=torch.float32, device=device)
        if variant.stage_tf32_split_launch(cp.data_ptr(), planes[0].data_ptr(),
                                           planes[1].data_ptr(), var_norms.data_ptr(),
                                           C, D, D, stream):
            raise AssertionError(f"{define}: stage_tf32_split launch failed")
        var_ptrs = [t.data_ptr() for t in (*planes, var_norms)] * 2
        var_d = torch.empty((Q, K), dtype=torch.float32, device=device)
        var_i = torch.empty((Q, K), dtype=torch.int32, device=device)

        def variant_k2():
            if variant.fused_knn_sweep_launch(
                    *var_ptrs, var_d.data_ptr(), var_i.data_ptr(), Q, C, D, M_FULL, K,
                    1, 1, 1, 0.0, stream):
                raise AssertionError(f"{define}: K2 launch failed")

        variant_k2()
        e = rel_errors(qp[:M_FULL], cp, var_i[:M_FULL], var_d[:M_FULL])
        emit({"phase": "exact_error_interval", "kernel": "fused_knn_sweep",
              "build": f"-D{define}", "interval_depth": depth or "none",
              "ms": cuda_ms(variant_k2, reps=3),
              "kernel_err": {"max": float(e.max()),
                             "p99_99": float(torch.quantile(e, 0.9999)),
                             "pairs": int(e.numel())}})
        if depth == 8:
            # the wgmma tile at 8 deep (K4's interval) against the mma.sync
            # Tf32x3 tile (K3a: the same all-pairs sweep from an all-+inf
            # carry) and their prologues' norms: bit for bit
            def ring_ids(n):
                i = torch.arange(n, dtype=torch.int32, device=device)
                return torch.where(i < M_FULL, i, -1)

            md, mi = fused_ring.block_merge_exact(
                qp, ring_ids(Q), cp, ring_ids(C), None,
                torch.full((Q, K), float("inf"), device=device),
                torch.full((Q, K), -1, dtype=torch.int32, device=device), c_tile=C_TILE)
            m_norms = fused_ring.stage_wire_norms(cp, None)
            torch.cuda.synchronize()
            diff = {"norms": int((var_norms != m_norms).sum()),
                    "ids": int((var_i != mi).sum()), "dists": int((var_d != md).sum())}
            emit({"phase": "wgmma_8deep_vs_mma_sync", "Q": Q, "C": C, "D": D, "k": K,
                  "differing": diff, "bitwise_equal": not any(diff.values())})
            if any(diff.values()):
                raise AssertionError(f"wgmma at 8 deep differs from mma.sync: {diff}")
            del md, mi, m_norms
        del variant, planes, var_norms, var_d, var_i

    # the product alone: torch.matmul on the same staged bf16 copies, in
    # query chunks; timed here only, never called by the port
    (qb, _), (cb, _) = staged
    chunk = 8192

    def product():
        for r0 in range(0, Q, chunk):
            torch.matmul(qb[r0:r0 + chunk], cb.T)

    def product_f32():  # the exact operands, f32 with TF32 off: cuBLAS SGEMM
        for r0 in range(0, Q, chunk):
            torch.matmul(qp[r0:r0 + chunk], cp.T)

    for call, fn, width in (("torch.matmul(bf16, bf16.T)", product, qb.shape[1]),
                            ("torch.matmul(f32, f32.T), TF32 off", product_f32, D)):
        fn()
        product_ms = cuda_ms(fn, reps=3)
        emit({"phase": "product_alone", "call": call, "Q": Q, "C": C,
              "width": width, "query_chunk": chunk, "ms": product_ms,
              "tflops_needed": needed_ops / (product_ms * 1e-3) / 1e12})

    # K2[c]'s bf16 wgmma tile's product alone (bf16_tile_dots with nothing
    # written: the same TMA ring and wgmma pipeline, no keys, no
    # selection), over the main shape's columns as K2[c]'s plan walks them
    main_plan = fused_knn.compress_sweep_plan(Q, M_FULL, sms)
    fused_knn.bf16_tile_dots(*staged, slices=main_plan["slices"], sink=True)
    product_ms = cuda_ms(lambda: fused_knn.bf16_tile_dots(
        *staged, slices=main_plan["slices"], sink=True), reps=3)
    emit({"phase": "product_alone", "call": "fused_knn.bf16_tile_dots",
          "cols_per_chunk": fused_knn.SWEEP_COLS, "Q": Q, "C": C,
          "width": qb.shape[1], "slices": main_plan["slices"], "ms": product_ms,
          "tflops_padded": 2.0 * Q * C * qb.shape[1] / (product_ms * 1e-3) / 1e12,
          "tflops_needed": needed_ops / (product_ms * 1e-3) / 1e12})

    # K2[c]'s output does not depend on its corpus split: forced splits
    # against the plan's, bit for bit, at the main shape and at bucket 1024
    def same(a, b):
        return torch.equal(a[1], b[1]) and torch.equal(
            torch.nan_to_num(a[0], posinf=-1.0), torch.nan_to_num(b[0], posinf=-1.0))

    bucket_q = fused_knn.stage_bf16_rows(qp[M_FULL - 1024:M_FULL].contiguous())
    for label, sq_, forced, all_pairs in (
            ("main_shape", staged[0], (2, 3, 7), True),
            ("bucket_1024", bucket_q, (1, 4, 33), False)):
        rows = sq_[0].shape[0]
        plan = fused_knn.compress_sweep_plan(rows, M_FULL, sms)
        want = fused_knn.launch_compress("fused_knn_sweep", sq_, staged[1], M_FULL, OV,
                                         C_TILE, all_pairs=all_pairs)
        ok = {S: same(fused_knn.launch_compress("fused_knn_sweep", sq_, staged[1], M_FULL,
                                                OV, C_TILE, all_pairs=all_pairs,
                                                slices=S), want)
              for S in forced}
        emit({"phase": "s_invariance", "kernel": "fused_knn_sweep[compress]",
              "shape": label, "Q": rows, "plan_slices": plan["slices"],
              "bitwise_equal_at_slices": ok})
        if not all(ok.values()):
            raise AssertionError(f"K2[c] at {label}: the output depends on the split {ok}")
        del want
    del bucket_q

    # the exact wgmma tile's product alone (split_tile_dots: the same
    # pipeline with the raw products written out, no keys, no selection):
    # the main path's queries against one 8192-column block, and a block
    # small enough to stay in L2; the bytes its ring takes in per second
    for rows, cols, reps in ((Q, 8192, 3), (2048, 4096, 50)):
        sq, sc = (tuple(t[:n] for t in split[1]) for n in (rows, cols))  # cp's planes
        fused_knn.split_tile_dots(sq, sc)
        product_ms = cuda_ms(lambda: fused_knn.split_tile_dots(sq, sc), reps=reps)
        boxes = -(-rows // 128) * -(-cols // 128) * (D // 16)  # 32 KB stages
        emit({"phase": "product_alone", "call": "fused_knn.split_tile_dots",
              "Q": rows, "C": cols, "width": D, "ms": product_ms,
              "tflops_three_passes": 6.0 * rows * cols * D / (product_ms * 1e-3) / 1e12,
              "ring_bytes_per_s": boxes * 32768 / (product_ms * 1e-3)})

    # the staging prologue alone, against its plain version (the copy bit
    # for bit, the norms within rtol 1e-5: the sum orders differ)
    def check_stage(label, got, want):
        (gc, gn), (wc, wn) = got, want
        if not torch.equal(gc.view(torch.int16), wc.view(torch.int16)):
            raise AssertionError(f"{label}: bf16 copy differs from the plain version")
        err = (gn.double() - wn.double()).abs()
        if not bool((err <= 1e-5 * wn.double().abs() + 1e-30).all()):
            raise AssertionError(f"{label}: norms outside rtol 1e-5")
        emit({"phase": "kernel_vs_plain", "case": label, "exact": False,
              "max_abs_err": float(err.max()), "ok": True})
        return float(err.max())

    def stage_bound(n, d, width, in_bytes_per_elem, extra_in=0.0):
        nbytes = in_bytes_per_elem * n * d + extra_in + 2.0 * n * width + 4.0 * n
        return bound(2.0 * n * d, nbytes, PEAK_FP32_FLOPS)

    def check_norms(label, got, want):
        """The exact prologue's norms against the plain f32 norms (rtol
        1e-5: the sum orders differ)."""
        err = (got.double() - want.double()).abs()
        if not bool((err <= 1e-5 * want.double().abs() + 1e-30).all()):
            raise AssertionError(f"{label}: norms outside rtol 1e-5")
        emit({"phase": "kernel_vs_plain", "case": label, "exact": False,
              "max_abs_err": float(err.max()), "ok": True})
        return float(err.max())

    def norms_bound(n, d, in_bytes_per_elem, extra_in=0.0):
        return exact_bound(2.0 * n * d, in_bytes_per_elem * n * d + extra_in + 4.0 * n)

    # K1/K2's prologue: the planes bit for bit against the plain split, the
    # norms within rtol 1e-5 of the plain f32 norms, and the norms equal to
    # the wgmma tile's own diagonal at every row position, bit for bit
    got_split = fused_knn.stage_tf32_split(cp)
    want_split = fused_knn.stage_tf32_split_reference(cp, fused_knn.split_width(D))
    for part, g, w in zip(("hi", "lo"), got_split, want_split):
        if not torch.equal(g, w):
            raise AssertionError(f"stage_tf32_split: the {part} plane differs")
    max_err["stage_tf32_split"] = check_norms(
        "stage_tf32_split/mnist60k_corpus", got_split[2], want_split[2])
    head = tuple(t[:4096] for t in got_split)
    shifted = tuple(torch.roll(t, 37, 0) for t in head)
    dots = fused_knn.split_tile_dots(head, shifted)
    rows = torch.arange(4096, device=device)
    if not torch.equal(dots[rows, (rows + 37) % 4096], head[2]):
        raise AssertionError("stage_tf32_split: norms differ from the tile's diagonal")
    emit({"phase": "kernel_vs_plain", "case": "stage_tf32_split/tile_diagonal",
          "rows": 4096, "column_shift": 37, "bitwise_equal": True, "ok": True})
    del got_split, want_split, head, shifted, dots
    width = fused_knn.split_width(D)
    timing["stage_tf32_split"] = {
        "ms": cuda_ms(lambda: fused_knn.stage_tf32_split(cp), reps=3),
        "plain_ms": cuda_ms(lambda: fused_knn.stage_tf32_split_reference(cp, width),
                            reps=3),
        # the rows read once, two planes and the norms written once; the
        # norms' products three times at the TF32 peak
        **exact_bound(2.0 * C * D, 4.0 * C * D + 8.0 * C * width + 4.0 * C)}
    emit({"phase": "kernel_time", "kernel": "stage_tf32_split", "rows": C, "D": D,
          "width": width, **timing["stage_tf32_split"]})

    width = fused_knn.staged_width(D)
    max_err["stage_bf16"] = check_stage(
        "stage_bf16/mnist60k_corpus", fused_knn.stage_bf16_rows(cp),
        fused_knn.stage_bf16_rows_reference(cp, width))
    timing["stage_bf16"] = {
        "ms": cuda_ms(lambda: fused_knn.stage_bf16_rows(cp), reps=3),
        "plain_ms": cuda_ms(lambda: fused_knn.stage_bf16_rows_reference(cp, width),
                            reps=3),
        **stage_bound(C, D, width, 4.0)}
    emit({"phase": "kernel_time", "kernel": "stage_bf16", "rows": C, "D": D,
          "width": width, **timing["stage_bf16"]})

    # ---- matmul_precision "default" / "high": K1 and K2 at the main shape:
    # the f32 mma.sync tile with each operand rounded to bf16 (one pass) or
    # split into bf16 hi + lo (three passes) in registers, after the norms
    # prologue stage_norms (once: the queries are the corpus's first rows).
    # Each against its plain version (ids judged by their rounded-operand
    # keys on SAMPLE_ROWS rows), every final slot against f64 and against
    # the oracle of rounded operands (precision_error)
    t_prec = time.perf_counter()
    norms = fused_knn.stage_f32_norms(cp)
    max_err["stage_norms"] = check_norms("stage_norms/mnist60k_corpus", norms,
                                         fused_knn.sq_norms(cp))
    timing["stage_norms"] = {
        "ms": cuda_ms(lambda: fused_knn.stage_f32_norms(cp), reps=3),
        "plain_ms": cuda_ms(lambda: fused_knn.sq_norms(cp), reps=3),
        "library_ms": cuda_ms(lambda: torch.einsum("ij,ij->i", cp, cp), reps=3),
        **norms_bound(C, D, 4.0)}
    emit({"phase": "kernel_time", "kernel": "stage_norms", "rows": C, "D": D,
          **timing["stage_norms"]})
    staged_n = ((norms[:Q],), (norms,))
    for precision in PRECISIONS:
        passes = 1 if precision == "default" else 3
        for base in ("fused_knn_tiles", "fused_knn_sweep"):
            name = f"{base}[{precision}]"
            kern = getattr(fused_knn, base)
            plain = getattr(fused_knn, base + "_reference")
            args = (qp, cp, M_FULL, K, Q_TILE, C_TILE)
            kw = dict(precision=precision)
            got, want = kern(*args, **kw), plain(*args, **kw)  # also the warm-ups
            call_ms = cuda_ms(lambda: kern(*args, **kw), reps=1)  # noqa: B023
            ms = cuda_ms(lambda: fused_knn.launch_mma(  # noqa: B023
                base, qp, cp, *staged_n, M_FULL, K, C_TILE, precision), reps=2)  # noqa: B023
            plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=1)  # noqa: B023
            max_err[name] = compare(f"{name}/mnist60k_main_shape", got, want, qp, cp,
                                    M_FULL, self_all, False, K,
                                    span_of(name, C_TILE, C), sample=sample,
                                    precision=precision)
            final = [(fused_knn._select(*t, K) if base == "fused_knn_tiles" else t)
                     for t in (got, want)]
            precision_error(name, precision, qp[:M_FULL], cp,
                            *((d[:M_FULL], i[:M_FULL]) for d, i in final))
            out_slots = (n_c if base == "fused_knn_tiles" else 1) * M_FULL * K
            nbytes = 4.0 * (2 * M_FULL * D) + 8.0 * out_slots
            timing[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                            **bound(passes * needed_ops, nbytes, PEAK_BF16_FLOPS),
                            "passes": passes,
                            "tflops": needed_ops / (ms * 1e-3) / 1e12}
            plan = fused_knn.mma_plan(base, Q, C, C_TILE, K, precision)
            plan["waves"] = plan["ctas"] / (plan["ctas_per_sm"] * sms)
            emit({"phase": "launch_plan", "kernel": name, "shape": "main_shape",
                  "sms": sms, **plan})
            emit({"phase": "kernel_time", "kernel": name, "Q": Q, "C": C, "D": D,
                  "k": K, **timing[name]})
            del got, want, final
    # the products alone at "high": three bf16 matmuls of the hi / lo copies
    qh, ch = qp.to(torch.bfloat16), cp.to(torch.bfloat16)
    ql, cl = (qp - qh.float()).to(torch.bfloat16), (cp - ch.float()).to(torch.bfloat16)

    def product_high():
        for r0 in range(0, Q, chunk):
            torch.matmul(ql[r0:r0 + chunk], ch.T)
            torch.matmul(qh[r0:r0 + chunk], cl.T)
            torch.matmul(qh[r0:r0 + chunk], ch.T)

    product_high()
    product_ms = cuda_ms(product_high, reps=1)
    emit({"phase": "product_alone", "call": "3 x torch.matmul(bf16, bf16.T) (high)",
          "Q": Q, "C": C, "width": D, "query_chunk": chunk, "ms": product_ms,
          "tflops_needed": 3 * needed_ops / (product_ms * 1e-3) / 1e12})
    del qh, ch, ql, cl, norms, staged_n
    emit({"phase": "precision_kernels_done", "seconds": time.perf_counter() - t_prec})
    del qp, cp, staged, qb, cb, split

    mark("fused_knn_kernels_and_precision")
    # ---- the ring block merge against its plain versions -----------------
    merge_modes = {
        "fused_block_merge[exact]": (fused_ring.block_merge_exact,
                                     fused_ring.block_merge_exact_reference),
        "fused_block_merge[compress]": (fused_ring.block_merge_compress,
                                        fused_ring.block_merge_compress_reference),
    }
    for name in merge_modes:
        max_err[name] = 0.0
    for wire, ops, (cd, ci) in ring_small_cases(device):
        kern, plain = merge_modes["fused_block_merge[exact]"]
        got = kern(*ops, cd, ci, c_tile=256)
        torch.cuda.synchronize()
        compare(f"fused_block_merge[exact]/small_int_{wire}", got,
                plain(*ops, cd, ci, c_tile=256), ops[0], None, 1 << 30, ops[1],
                True, K, None)
        kern, plain = merge_modes["fused_block_merge[compress]"]
        got = kern(*ops, ov=OV, c_tile=256)
        torch.cuda.synchronize()
        compare_positions(f"fused_block_merge[compress]/small_int_{wire}", got,
                          plain(*ops, ov=OV, c_tile=256), None, None, None,
                          None, 256, True)

    def ring_operands(P, rank_q, rank_b, wire=None):
        """Rank ``rank_q``'s query shard and rank ``rank_b``'s block of the
        main path's ring at P ranks (ring_tiles' padding), on the card."""
        cfg = KNNConfig(k=K)
        q_tile, c_tile, q_pad, c_pad = ring.ring_tiles(cfg, M_FULL, M_FULL, 1, P)
        ql, b = q_pad // P, c_pad // P
        rows = slice(rank_q * ql, (rank_q + 1) * ql)
        cols = slice(rank_b * b, (rank_b + 1) * b)
        qs = pad_rows_any(Xcd, q_pad)[rows].contiguous()
        ids = torch.from_numpy(make_global_ids(M_FULL, c_pad)).to(device)
        qids = torch.arange(q_pad, dtype=torch.int32, device=device)
        qids = torch.where(qids < M_FULL, qids, -1)[rows].contiguous()
        blk = pad_rows_any(Xcd, c_pad)[cols].contiguous()
        scale = None
        if wire == "int8":
            blk, scale = ring.quantize_ring_block(blk)
        return (qs, qids, blk, ids[cols].contiguous(), scale), q_tile, c_tile

    ring_timing = {}
    merge_shapes = [("p1_mnist60k", 1, 0, 0, None),
                    ("p4_shard", 4, 0, 1, None), ("p4_shard_int8", 4, 0, 1, "int8")]
    for shape, P, rq, rb, wire in merge_shapes:
        ops, q_tile, c_tile = ring_operands(P, rq, rb, wire)
        qs, qids, blk, bids, scale = ops
        rows_f32 = blk.float() if scale is None else blk.float() * scale[:, None]
        # the rows the kernels see, by global id: dequantized on the int8 wire
        c_true = Xcd if wire is None else dequantize_rows(*quantize_rows(Xcd))
        ql, b = qs.shape[0], blk.shape[0]
        if rq == rb:
            carry = init_topk(ql, K, device=device)
        else:  # the carry the rank holds after merging its own block
            carry = fused_ring.block_merge_exact_reference(
                *ring_operands(P, rq, rq, wire)[0], *init_topk(ql, K, device=device),
                c_tile=c_tile)
        sub = sample[sample < ql] if ql < M_FULL else sample
        real_q = int((qids >= 0).sum())
        real_b = int((bids >= 0).sum())
        # K3b's staging prologue on this wire against its plain version
        width = fused_knn.staged_width(D)
        label = f"stage_bf16[wire]/{shape}"
        err = check_stage(label, fused_ring.stage_wire_rows(blk, scale),
                          fused_knn.stage_bf16_rows_reference(rows_f32, width))
        max_err["stage_bf16[wire]"] = max(max_err.get("stage_bf16[wire]", 0.0), err)
        staged_q = fused_ring.stage_wire_rows(qs, None)
        staged_b = fused_ring.stage_wire_rows(blk, scale)
        # K3a's exact prologue on this wire against its plain version
        q_norms = fused_ring.stage_wire_norms(qs, None)
        b_norms = fused_ring.stage_wire_norms(blk, scale)
        err = check_norms(f"stage_tf32[wire]/{shape}", b_norms,
                          fused_ring.stage_wire_norms_reference(blk, scale))
        max_err["stage_tf32[wire]"] = max(max_err.get("stage_tf32[wire]", 0.0), err)
        if shape == "p1_mnist60k":
            timing["stage_tf32[wire]"] = {
                "ms": cuda_ms(lambda: fused_ring.stage_wire_norms(blk, scale), reps=3),
                "plain_ms": cuda_ms(lambda: fused_ring.stage_wire_norms_reference(
                    blk, scale), reps=3),
                "library_ms": cuda_ms(lambda: torch.einsum("ij,ij->i", blk, blk),
                                      reps=3),
                **norms_bound(b, D, blk.element_size(),
                              0.0 if scale is None else 4.0 * b)}
            emit({"phase": "kernel_time", "kernel": "stage_tf32[wire]",
                  "shape": shape, "rows": b, "D": D, "wire": wire or "float32",
                  **timing["stage_tf32[wire]"]})
        if shape == "p1_mnist60k":
            timing["stage_bf16[wire]"] = {
                "ms": cuda_ms(lambda: fused_ring.stage_wire_rows(blk, scale), reps=3),
                "plain_ms": cuda_ms(lambda: fused_knn.stage_bf16_rows_reference(
                    fused_ring._wire_rows(blk, scale), width), reps=3),
                **stage_bound(b, D, width, blk.element_size(),
                              0.0 if scale is None else 4.0 * b)}
            emit({"phase": "kernel_time", "kernel": "stage_bf16[wire]",
                  "shape": shape, "rows": b, "D": D, "width": width,
                  "wire": wire or "float32", **timing["stage_bf16[wire]"]})
        for name, (kern, plain) in merge_modes.items():
            if name.endswith("[exact]"):
                call = lambda: kern(*ops, *carry, c_tile=c_tile)  # noqa: E731
                pcall = lambda: plain(*ops, *carry, c_tile=c_tile)  # noqa: E731
                alone = lambda: kern(*ops, *carry, c_tile=c_tile,  # noqa: E731
                                     query_norms=q_norms, block_norms=b_norms)
            else:
                call = lambda: kern(*ops, ov=OV, c_tile=c_tile)  # noqa: E731
                pcall = lambda: plain(*ops, ov=OV, c_tile=c_tile)  # noqa: E731
                alone = lambda: fused_ring.block_merge_compress_staged(  # noqa: E731
                    staged_q, qids, staged_b, bids, ov=OV, c_tile=c_tile)
            got, want = call(), pcall()
            ms = cuda_ms(alone, reps=3)
            call_ms = cuda_ms(call, reps=3)
            plain_ms = cuda_ms(pcall, reps=3)
            if name.endswith("[exact]"):
                err = compare(f"{name}/{shape}", got, want, qs, c_true, M_FULL,
                              qids, False, K, None,
                              sample=sub if ql >= SAMPLE_ROWS else None)
                out_bytes = 8.0 * ql * K + 8.0 * ql * K  # carry in and out
                plan = fused_ring.exact_plan(blk.dtype, ql, K)
                plan["waves"] = plan["ctas"] / (plan["ctas_per_sm"] * sms)
                emit({"phase": "launch_plan", "kernel": name, "shape": shape,
                      "sms": sms, **plan})
                if shape == "p1_mnist60k":
                    real = qids >= 0
                    exact_error(name, qs[real], c_true,
                                *((d[real], i[real]) for d, i in (got, want)))
            else:
                err = compare_positions(f"{name}/{shape}", got, want, qs,
                                        rows_f32, bids, qids, c_tile, False,
                                        sample=sub)
                out_bytes = 4.0 * real_q * (b // c_tile) * OV
            max_err[name] = max(max_err[name], err)
            in_bytes = 4.0 * real_q * D + blk.element_size() * real_b * D
            ops_needed = 2.0 * real_q * real_b * D
            entry = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     **(exact_bound(ops_needed, in_bytes + out_bytes)
                        if name.endswith("[exact]") else
                        bound(ops_needed, in_bytes + out_bytes, PEAK_BF16_FLOPS))}
            ring_timing[(name, shape)] = entry
            emit({"phase": "kernel_time", "kernel": name, "shape": shape,
                  "q_local": ql, "b": b, "D": D, "k": K, "ov": OV,
                  "wire": wire or "float32", **entry})
            del got, want
        del staged_q, staged_b, q_norms, b_norms

    # K3a at "default" / "high" at the ring's P=1 MNIST shape, from an empty
    # carry: the mma.sync tile on Bf16x1F32 / Bf16x3 with the f32 norms of
    # stage_tf32[wire]
    ops, q_tile, c_tile = ring_operands(1, 0, 0)
    qs, qids = ops[0], ops[1]
    q_norms = fused_ring.stage_wire_norms(qs, None)
    b_norms = fused_ring.stage_wire_norms(ops[2], None)
    carry = init_topk(qs.shape[0], K, device=device)
    real = qids >= 0
    real_q, real_b = int(real.sum()), int((ops[3] >= 0).sum())
    for precision in PRECISIONS:
        name = f"fused_block_merge[{precision}]"
        call = lambda: fused_ring.block_merge_exact(  # noqa: E731
            *ops, *carry, c_tile=c_tile, precision=precision)  # noqa: B023
        alone = lambda: fused_ring.block_merge_exact(  # noqa: E731
            *ops, *carry, c_tile=c_tile, query_norms=q_norms, block_norms=b_norms,
            precision=precision)  # noqa: B023
        pcall = lambda: fused_ring.block_merge_exact_reference(  # noqa: E731
            *ops, *carry, c_tile=c_tile, precision=precision)  # noqa: B023
        got, want = call(), pcall()
        ms, call_ms, plain_ms = (cuda_ms(f, reps=1) for f in (alone, call, pcall))
        max_err[name] = compare(f"{name}/p1_mnist60k", got, want, qs, Xcd, M_FULL, qids,
                                False, K, None, sample=sample, precision=precision)
        precision_error(name, precision, qs[real], Xcd,
                        *((d[real], i[real]) for d, i in (got, want)))
        plan = fused_ring.exact_plan(torch.float32, qs.shape[0], K, precision)
        plan["waves"] = plan["ctas"] / (plan["ctas_per_sm"] * sms)
        emit({"phase": "launch_plan", "kernel": name, "shape": "p1_mnist60k",
              "sms": sms, **plan})
        ops_needed = 2.0 * real_q * real_b * D
        nbytes = 4.0 * real_q * D + 4.0 * real_b * D + 16.0 * qs.shape[0] * K
        entry = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                 **bound((1 if precision == "default" else 3) * ops_needed, nbytes,
                         PEAK_BF16_FLOPS)}
        ring_timing[(name, "p1_mnist60k")] = entry
        emit({"phase": "kernel_time", "kernel": name, "shape": "p1_mnist60k",
              "q_local": qs.shape[0], "b": ops[2].shape[0], "D": D, "k": K, **entry})
        del got, want
    del ops, qs, qids, q_norms, b_norms, carry, real

    mark("ring_merges")
    # ---- the ring transport (K4, K5) against its plain versions ----------
    mesh = make_ring_mesh(4) if count >= 4 else make_ring_mesh(devices=[device] * 4)
    devices4 = list(mesh)
    cards = len({str(d) for d in devices4})
    emit({"phase": "mesh", "ranks": [str(d) for d in mesh], "cards": cards})
    for name in ("fused_round_dma", "fused_rotation_grid"):
        max_err[name] = 0.0
    slot, landing_slots = fused_rotation.slot, fused_rotation.landing_slots

    def cat(carries):
        return (torch.cat([c[0].to(device) for c in carries]),
                torch.cat([c[1].to(device) for c in carries]))

    def same_landing(name, land, blocks):
        P = len(blocks)
        for r in range(P):
            for have, sent in zip(land[(r + 1) % P], blocks[r]):
                if (have is None) != (sent is None) or (
                        sent is not None
                        and not torch.equal(have, sent.to(have.device))):
                    raise AssertionError(
                        f"{name}: rank {(r + 1) % P} did not land rank {r}'s block")

    def lands(blocks, i):
        return [slot(landing_slots(*b), i) for b in blocks]

    for devs in ([device], devices4):
        P = len(devs)
        for wire in ("float32", "bfloat16", "int8"):
            qs, qi, bl, ca = [], [], [], []
            for r, d in enumerate(devs):
                _, (q, qids, b, bids, scale), carry = next(
                    c for c in ring_small_cases(d, seed=1 + r, id_base=100000 * r)
                    if c[0] == wire)
                qs.append(q)
                qi.append(qids)
                bl.append((b, bids, scale))
                ca.append(carry)
            tr = fused_rotation.ring_transport(devs)
            land = lands(bl, 0)
            got = fused_rotation.fused_round_dma(tr, qs, qi, bl, ca, land,
                                                 c_tile=256)
            sync_all()
            want = fused_rotation.fused_round_dma_reference(
                qs, qi, bl, ca, lands(bl, 0), c_tile=256)
            case = f"small_int_P{P}_{wire}"
            same_landing(f"fused_round_dma/{case}", land, bl)
            qid_all = torch.cat([t.to(device) for t in qi])
            compare(f"fused_round_dma/{case}", cat(got), cat(want), None, None,
                    1 << 30, qid_all, True, K, None)
            if wire == "int8":
                continue
            got = fused_rotation.fused_rotation_grid(
                tr, qs, qi, bl, ca, [landing_slots(*b) for b in bl], c_tile=256)
            sync_all()
            want = fused_rotation.fused_rotation_grid_reference(
                qs, qi, bl, ca, [landing_slots(*b) for b in bl], c_tile=256)
            compare(f"fused_rotation_grid/{case}", cat(got), cat(want), None,
                    None, 1 << 30, qid_all, True, K, None)

    cfg_fused = KNNConfig(k=K, ring_fusion="fused")
    row_ids = np.arange(M_FULL, dtype=np.int32)
    transport_timing = {}

    def real_ops_bytes(q_sh, qid_sh, blocks, ranks, rounds):
        """Needed FLOP and bytes of one launch over ``ranks``: each rank
        merges ``rounds`` blocks of real rows; bytes count its queries,
        blocks and ids read once, its carry read and written once."""
        ops = nbytes = 0.0
        for r in ranks:
            real_q = int((qid_sh[r] >= 0).sum())
            ql = q_sh[r].shape[0]
            nbytes += 4.0 * real_q * D + 16.0 * ql * K
            for j in range(rounds):
                blk, bids, scl = blocks[(r - j) % len(blocks)][:3]
                real_b = int((bids >= 0).sum())
                ops += 2.0 * real_q * real_b * D
                nbytes += (blk.element_size() * real_b * D + 4.0 * bids.numel()
                           + (0 if scl is None else 4.0 * scl.numel()))
        return ops, nbytes

    for shape, devs in (("p1_mnist60k", [device]), ("p4_round", devices4)):
        P = len(devs)
        q_tile, c_tile, q_sh, qid_sh, travelers = ring.ring_shards(
            cfg_fused, Xc, Xc, row_ids, devs)
        # the travelers with their norms, staged once as the ring driver
        # does: for K5 (mma.sync) by stage_tf32[wire]; for K4 (wgmma, the
        # f32 wire) by its own prologue, with the planes its tile reads
        blocks0 = [(b, i, s, fused_ring.stage_wire_norms(b, s))
                   for b, i, s in travelers[0]]
        q_norms = [fused_ring.stage_wire_norms(q, None) for q in q_sh]
        staged_q = [fused_rotation.stage_round_planes(q) for q in q_sh]
        blocks4 = [(b, i, s, n, hi, lo) for (b, i, s), (hi, lo, n) in zip(
            travelers[0], (fused_rotation.stage_round_planes(b) for b, _, _ in travelers[0]))]
        if shape == "p1_mnist60k":  # K4's prologue against its plain version
            blk = blocks4[0][0]
            want_split = fused_knn.stage_tf32_split_reference(blk, fused_knn.split_width(D))
            for part, g, w in zip(("hi", "lo"), blocks4[0][4:], want_split):
                if not torch.equal(g, w):
                    raise AssertionError(f"stage_tf32_split[ring]: the {part} plane differs")
            max_err["stage_tf32_split[ring]"] = check_norms(
                "stage_tf32_split[ring]/p1_mnist60k", blocks4[0][3], want_split[2])
            # at 8 deep the wgmma diagonal is the mma.sync one: K3a may take
            # K4's norms (the resumable ring's last round)
            if not torch.equal(blocks4[0][3], blocks0[0][3]):
                raise AssertionError("stage_tf32_split[ring] norms differ from stage_tf32[wire]")
            emit({"phase": "kernel_vs_plain", "case": "stage_tf32_split[ring]/equals_wire_norms",
                  "rows": blk.shape[0], "bitwise_equal": True, "ok": True})
            width = fused_knn.split_width(D)
            timing["stage_tf32_split[ring]"] = {
                "ms": cuda_ms(lambda: fused_rotation.stage_round_planes(blk), reps=3),
                "plain_ms": cuda_ms(lambda: fused_knn.stage_tf32_split_reference(
                    blk, width), reps=3),
                **exact_bound(2.0 * blk.shape[0] * D,
                              4.0 * blk.shape[0] * D + 8.0 * blk.shape[0] * width
                              + 4.0 * blk.shape[0])}
            emit({"phase": "kernel_time", "kernel": "stage_tf32_split[ring]",
                  "rows": blk.shape[0], "D": D, "width": width,
                  **timing["stage_tf32_split[ring]"]})
            del want_split
        init = [init_topk(q.shape[0], K, device=q.device) for q in q_sh]
        blocks, carries = blocks4, init
        tr = fused_rotation.ring_transport(devs)
        if P > 1:  # round 1: own blocks merged, the blocks one rank on
            blocks = lands(blocks4, 1)
            carries = fused_rotation.fused_round_dma_reference(
                q_sh, qid_sh, blocks4, init, blocks, c_tile=c_tile)
        land, want_land = lands(blocks, 0), lands(blocks, 0)

        def k4():
            return fused_rotation.fused_round_dma(
                tr, q_sh, qid_sh, blocks, carries, land, c_tile=c_tile,
                query_norms=[t[2] for t in staged_q],
                query_planes=[t[:2] for t in staged_q])

        def k4_plain():
            return fused_rotation.fused_round_dma_reference(
                q_sh, qid_sh, blocks, carries, want_land, c_tile=c_tile)

        one_card = tr.local[tr.cards[0]]  # the ranks of one launch

        def k3a_and_copy():  # per K4 launch: K3a and the traveler's copy_
            for r in one_card:
                fused_ring.block_merge_exact(
                    q_sh[r], qid_sh[r], *blocks[r][:3], *carries[r], c_tile=c_tile,
                    query_norms=staged_q[r][2], block_norms=blocks[r][3])
                for dst, src in zip(land[(r + 1) % P], blocks[r]):
                    if src is not None:
                        dst.copy_(src)

        got, want = k4(), k4_plain()
        sync_all()
        same_landing(f"fused_round_dma/{shape}", land, blocks)
        ms = launch_device_ms(k4, 3, "round_dma_kernel")
        call_ms = mesh_ms(k4, 3, devs)
        plain_ms = mesh_ms(k4_plain, 3, devs)
        k3a_and_copy()
        lib_ms = mesh_ms(k3a_and_copy, 3, devs)
        q_all = torch.cat([q.to(device) for q in q_sh])
        qid_all = torch.cat([t.to(device) for t in qid_sh])
        err = compare(f"fused_round_dma/{shape}", cat(got), cat(want), q_all,
                      Xcd, M_FULL, qid_all, False, K, None, sample=sample)
        max_err["fused_round_dma"] = max(max_err["fused_round_dma"], err)
        if shape == "p1_mnist60k":  # K3a's gate
            real = qid_all >= 0
            exact_error("fused_round_dma", q_all[real], Xcd,
                        *((d[real], i[real]) for d, i in (cat(got), cat(want))))
        plan = fused_rotation.ring_kernel_plan("round", torch.float32, len(one_card),
                                               q_sh[0].shape[0], K)
        plan["waves"] = plan["items_per_round"] / plan["grid"]
        emit({"phase": "launch_plan", "kernel": "fused_round_dma", "shape": shape,
              "sms": sms, **plan})
        ops, nbytes = real_ops_bytes(q_sh, qid_sh, blocks, one_card, 1)
        for r in one_card:  # the query planes, the block's norms and planes
            nbytes += sum(t.numel() * t.element_size()
                          for t in (*staged_q[r][:2], *blocks[r][3:]))
        for r in one_card:  # the landed traveler, written once
            nbytes += sum(t.numel() * t.element_size()
                          for t in blocks[r] if t is not None)
        entry = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, **exact_bound(ops, nbytes)}
        transport_timing[("fused_round_dma", shape)] = entry
        emit({"phase": "kernel_time", "kernel": "fused_round_dma",
              "shape": shape, "ranks": P, "ranks_per_launch": len(one_card),
              "q_local": q_sh[0].shape[0], "b": blocks[0][0].shape[0], "D": D,
              "k": K, "library": "K3a + Tensor.copy_ per rank of the launch",
              **entry})
        del got, want, land, want_land
        if P == 1:
            continue

        slots, want_slots = ([landing_slots(*b) for b in blocks0]
                             for _ in range(2))

        def k5():
            return fused_rotation.fused_rotation_grid(
                tr, q_sh, qid_sh, blocks0, init, slots, c_tile=c_tile,
                query_norms=q_norms)

        def k5_plain():
            return fused_rotation.fused_rotation_grid_reference(
                q_sh, qid_sh, blocks0, init, want_slots, c_tile=c_tile)

        def driver_rotation():  # the same rotation: Tensor.to and K3a
            run = ring.RingRun(cfg_fused, devs, True, "driver", q_sh, qid_sh,
                               [[b[:3] for b in blocks0]], list(init), q_tile,
                               c_tile)
            for rnd in range(P):
                run.round(merge_bwd=False, rotate=rnd < P - 1)
            return run.carries

        got, want = k5(), k5_plain()
        sync_all()
        ms = launch_device_ms(k5, 3, "rotation_grid_kernel")
        call_ms = mesh_ms(k5, 3, devs)
        plain_ms = mesh_ms(k5_plain, 3, devs)
        driver_rotation()
        lib_ms = mesh_ms(driver_rotation, 3, devs)
        err = compare(f"fused_rotation_grid/p4_rotation", cat(got), cat(want),
                      q_all, Xcd, M_FULL, qid_all, False, K, None,
                      sample=sample)
        max_err["fused_rotation_grid"] = max(max_err["fused_rotation_grid"], err)
        ops, nbytes = real_ops_bytes(q_sh, qid_sh, blocks0, one_card, P)
        entry = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, **exact_bound(ops, nbytes),
                 "plan": fused_rotation.ring_kernel_plan(
                     "grid", blocks0[0][0].dtype, len(one_card), q_sh[0].shape[0], K)}
        transport_timing[("fused_rotation_grid", "p4_rotation")] = entry
        emit({"phase": "kernel_time", "kernel": "fused_rotation_grid",
              "shape": "p4_rotation", "ranks": P,
              "ranks_per_launch": len(one_card), "q_local": q_sh[0].shape[0],
              "b": blocks0[0][0].shape[0], "D": D, "k": K,
              "library": "the driver-transport rotation with K3a", **entry})
        del got, want, slots, want_slots
    del q_sh, qid_sh, travelers, blocks0, blocks4, blocks, carries, init, q_norms, staged_q

    # K4 (one P=4 round: round 1) and K5 (the P=4 rotation) at "default" /
    # "high": the mma.sync round kernel on the f32 wire (no planes) and the
    # grid kernel, their travelers carrying the norms of stage_tf32[wire]
    q_tile, c_tile, q_sh, qid_sh, travelers = ring.ring_shards(
        cfg_fused, Xc, Xc, row_ids, devices4)
    blocks0 = [(b, i, s, fused_ring.stage_wire_norms(b, s)) for b, i, s in travelers[0]]
    q_norms = [fused_ring.stage_wire_norms(q, None) for q in q_sh]
    init = [init_topk(q.shape[0], K, device=q.device) for q in q_sh]
    tr = fused_rotation.ring_transport(devices4)
    one_card = tr.local[tr.cards[0]]
    q_all = torch.cat([q.to(device) for q in q_sh])
    qid_all = torch.cat([t.to(device) for t in qid_sh])
    for precision in PRECISIONS:
        passes = 1 if precision == "default" else 3
        blocks = lands(blocks0, 1)
        carries = fused_rotation.fused_round_dma_reference(
            q_sh, qid_sh, blocks0, init, blocks, c_tile=c_tile, precision=precision)
        land, want_land = lands(blocks, 0), lands(blocks, 0)
        k4 = lambda: fused_rotation.fused_round_dma(  # noqa: E731
            tr, q_sh, qid_sh, blocks, carries, land, c_tile=c_tile,  # noqa: B023
            query_norms=q_norms, precision=precision)  # noqa: B023
        k4_plain = lambda: fused_rotation.fused_round_dma_reference(  # noqa: E731
            q_sh, qid_sh, blocks, carries, want_land, c_tile=c_tile,  # noqa: B023
            precision=precision)  # noqa: B023
        name = f"fused_round_dma[{precision}]"
        got, want = k4(), k4_plain()
        sync_all()
        same_landing(f"{name}/p4_round", land, blocks)
        ms = launch_device_ms(k4, 2, "round_dma_kernel")
        call_ms, plain_ms = mesh_ms(k4, 1, devices4), mesh_ms(k4_plain, 1, devices4)
        max_err[name] = compare(f"{name}/p4_round", cat(got), cat(want), q_all, Xcd,
                                M_FULL, qid_all, False, K, None, sample=sample,
                                precision=precision)
        plan = fused_rotation.ring_kernel_plan("round", torch.float32, len(one_card),
                                               q_sh[0].shape[0], K, precision)
        emit({"phase": "launch_plan", "kernel": name, "shape": "p4_round",
              "sms": sms, **plan})
        ops, nbytes = real_ops_bytes(q_sh, qid_sh, blocks, one_card, 1)
        transport_timing[(name, "p4_round")] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            **bound(passes * ops, nbytes, PEAK_BF16_FLOPS)}
        emit({"phase": "kernel_time", "kernel": name, "shape": "p4_round", "ranks": 4,
              **transport_timing[(name, "p4_round")]})
        del got, want, land, want_land, blocks, carries
        name = f"fused_rotation_grid[{precision}]"
        slots, want_slots = ([landing_slots(*b) for b in blocks0] for _ in range(2))
        k5 = lambda: fused_rotation.fused_rotation_grid(  # noqa: E731
            tr, q_sh, qid_sh, blocks0, init, slots, c_tile=c_tile,  # noqa: B023
            query_norms=q_norms, precision=precision)  # noqa: B023
        k5_plain = lambda: fused_rotation.fused_rotation_grid_reference(  # noqa: E731
            q_sh, qid_sh, blocks0, init, want_slots, c_tile=c_tile,  # noqa: B023
            precision=precision)  # noqa: B023
        got, want = k5(), k5_plain()
        sync_all()
        ms = launch_device_ms(k5, 2, "rotation_grid_kernel")
        call_ms, plain_ms = mesh_ms(k5, 1, devices4), mesh_ms(k5_plain, 1, devices4)
        max_err[name] = compare(f"{name}/p4_rotation", cat(got), cat(want), q_all, Xcd,
                                M_FULL, qid_all, False, K, None, sample=sample,
                                precision=precision)
        real = qid_all >= 0
        precision_error(name, precision, q_all[real], Xcd,
                        *((d[real], i[real]) for d, i in (cat(got), cat(want))))
        ops, nbytes = real_ops_bytes(q_sh, qid_sh, blocks0, one_card, 4)
        transport_timing[(name, "p4_rotation")] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            **bound(passes * ops, nbytes, PEAK_BF16_FLOPS),
            "plan": fused_rotation.ring_kernel_plan("grid", torch.float32,
                                                    len(one_card), q_sh[0].shape[0],
                                                    K, precision)}
        emit({"phase": "kernel_time", "kernel": name, "shape": "p4_rotation",
              "ranks": 4, **transport_timing[(name, "p4_rotation")]})
        del got, want, slots, want_slots
    del q_sh, qid_sh, travelers, blocks0, q_norms, init, q_all, qid_all

    mark("ring_transport")
    # ---- planted duplicates through the mixed and exact paths on the card --
    # An exact duplicate pair and a near-twin one pixel off by 8. On the
    # mixed paths the compress keys of the two collapse and only the exact
    # rerank drops the duplicate by the zero rule; on the exact paths the
    # TF32x3 tile must give the pair exactly 0 (norms from the same product
    # sequence) and keep the twin first at d^2 = 64.
    Xdup, _ = make_mnist_like(8192, seed=3)
    Xdup[7] = Xdup[3]
    Xdup[42] = Xdup[11]
    Xdup[42, 0] += 8.0
    dup_row_ids = np.arange(8192, dtype=np.int32)
    # the exact paths' f32 keys of the twin may differ from 64 by their
    # product error, up to 2x the gate floor of the pair's q^2 + c^2 (the
    # mixed paths rerank in f64: within 0.01)
    dup_c = Xdup - Xdup.astype(np.float64).mean(0)
    twin_tol = {"mixed": 0.01,
                "exact": 2 * ERROR_GATE * float((dup_c[[11, 42]] ** 2).sum())}

    def dup_ok(ids, dists, policy):
        return (7 not in ids[3] and 3 not in ids[7] and ids[11][0] == 42
                and ids[42][0] == 11
                and abs(float(dists[11][0]) - 64.0) <= twin_tol[policy])

    def resumed_dup():
        cfg = KNNConfig(k=K, backend="ring-overlap", ring_fusion="fused")
        with tempfile.TemporaryDirectory() as ckpt:
            all_knn_ring_resumable(Xdup, Xdup, dup_row_ids, cfg, mesh=mesh4,
                                   device=device, checkpoint_dir=ckpt,
                                   stop_after_rounds=2)
            return all_knn_ring_resumable(Xdup, Xdup, dup_row_ids, cfg, mesh=mesh4,
                                          device=device, checkpoint_dir=ckpt)

    mesh4 = [device] * 4
    for policy in ("mixed", "exact"):
        paths = [
            ("pallas/tiles", dict(backend="pallas", pallas_variant="tiles")),
            ("pallas/sweep", dict(backend="pallas", pallas_variant="sweep")),
            ("ring/P1", dict(backend="ring-overlap", ring_fusion="fused",
                             num_devices=1)),
            ("ring/P4/bidir", dict(backend="ring-overlap", ring_fusion="fused",
                                   mesh=mesh4, ring_schedule="bidir"))]
        if policy == "mixed":
            paths.append(("serial", dict(backend="serial")))
        else:
            paths += [("ring/P4/fused-dma", dict(backend="ring-overlap",
                                                 ring_fusion="fused", mesh=mesh4)),
                      ("ring/P4/fused-grid", dict(backend="ring-overlap",
                                                  ring_fusion="fused", mesh=mesh4,
                                                  ring_fused_rotation="grid")),
                      ("ring/P4/resume", None)]
        for label, kw in paths:
            if kw is None:
                d, i = resumed_dup()
            else:
                res = all_knn(Xdup, k=K, precision_policy=policy, device=device,
                              **kw)
                d, i = res.dists, res.ids
            ids, dists = i.cpu().numpy(), d.cpu().numpy()
            ok = dup_ok(ids, dists, policy)
            emit({"phase": f"{policy}_duplicates", "path": label,
                  "twin_d2": float(dists[11][0]), "twin_tol": twin_tol[policy],
                  "ok": ok})
            if not ok:
                raise AssertionError(f"{policy} {label}: planted duplicates not handled")

    # ---- the PyTorch yardsticks (library_ms), on the same card inputs -----
    library = {}
    for policy in ("exact", "mixed"):
        cfg = KNNConfig(k=K, backend="serial", precision_policy=policy)

        def serial():
            return all_knn_serial(Xcd, Xcd, row_ids, cfg, device)

        serial()  # warm-up
        library[("serial", policy)] = cuda_ms(serial, reps=3)
        emit({"phase": "library_time", "call": "backends.serial.all_knn_serial",
              "precision_policy": policy, "m": M_FULL, "d": D, "k": K,
              "ms": library[("serial", policy)]})
    ops, q_tile, c_tile = ring_operands(1, 0, 0)
    for policy in ("exact", "mixed"):
        cfg = KNNConfig(k=K, precision_policy=policy)

        def xla_round():
            return ring._merge(ops[0], ops[1], ops[2:], init_topk(
                ops[0].shape[0], K, device=device), cfg, q_tile, c_tile)

        xla_round()  # warm-up
        library[("xla_round", policy)] = cuda_ms(xla_round, reps=3)
        emit({"phase": "library_time", "call": "backends.ring._merge (xla form)",
              "precision_policy": policy, "shape": "p1_mnist60k",
              "ms": library[("xla_round", policy)]})
    del ops

    mark("duplicates_and_yardsticks")
    # ---- the main paths ---------------------------------------------------
    sample256 = np.linspace(0, M_FULL - 1, num=256, dtype=np.int64)

    def oracle(corpus, rtol):
        """f64 ids of the 256 sampled rows' k nearest corpus rows: self
        excluded, and zero distance (d <= rtol (q^2 + c^2), or d <= 1e-9
        when rtol is 0), ties to the lower id."""
        c = corpus.astype(np.float64)
        q = c[sample256] if corpus is X else Xc[sample256].astype(np.float64)
        q_sq, c_sq = (q ** 2).sum(1)[:, None], (c ** 2).sum(1)[None, :]
        d = q_sq + c_sq - 2.0 * (q @ c.T)
        d[d <= (rtol * (q_sq + c_sq) if rtol else 1e-9)] = np.inf
        d[np.arange(len(sample256)), sample256] = np.inf  # leave-one-out
        return np.argsort(d, axis=1, kind="stable")[:, :K]

    want_ids = oracle(X, 0.0)  # the reference's workload, on the input data
    # what the int8 wire hands the rerank: each row's dequantized codes
    want_wire = oracle(dequantize_rows(*quantize_rows(Xcd)).cpu().numpy(), 1e-6)

    def recall(ids, want=want_ids) -> float:
        got = ids[torch.as_tensor(sample256, device=ids.device)].cpu().numpy()
        return float((want[:, :, None] == got[:, None, :]).any(-1).mean())

    Xd = torch.from_numpy(X).to(device)

    def median_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            sync_all()
            t0 = time.perf_counter()
            out = fn()
            sync_all()
            times.append(time.perf_counter() - t0)
        return out, 1e3 * statistics.median(times), times

    def drive(label, run, host, dev_input, expect, wire_oracle=False, reps=3,
              oracle=None):
        """One main-path run (``run`` returns (KNNResult, matches)) with the
        launch counts set to 0 just before it and read just after, then the
        timing reps (warm-up excluded): the host-input form (numpy corpus,
        what KNNClassifier users call) and the device-input form (corpus
        already on the card, centered there). ``expect`` maps kernel modes
        to the launches the run must show. The recall gate holds against
        the input data's oracle, or with ``wire_oracle`` (the int8 wire)
        against the oracle of the rows the wire delivers: quantization is a
        configured loss the exact rerank cannot undo, so there the input
        data's recall is reported beside it. Returns (line, ids); the
        result is kept in ``results``."""
        reset_counts()
        result, matches = run()
        sync_all()
        counts = {k: v for k, v in read_counts().items() if v}
        res, host_ms, host_s = median_ms(host, reps)
        _, dev_ms, dev_s = median_ms(dev_input, reps)
        ids = result.ids
        if ids.shape != (M_FULL, K) or not bool(torch.isfinite(result.dists).all()):
            raise AssertionError(f"{label}: bad result shape or values")
        if not torch.equal(res.ids, ids):
            raise AssertionError(f"{label}: reps disagree")
        rec = recall(ids)
        line = {"phase": "main_path", "path": label, "m": M_FULL, "d": D,
                "k": K, "allknn_ms_median": host_ms, "allknn_s_reps": host_s,
                "device_input_ms_median": dev_ms, "device_input_s_reps": dev_s,
                "matches": matches, "total": M_FULL, "recall_at_10": rec,
                "launches": counts}
        if wire_oracle or oracle is not None:
            line["recall_at_10_input_data"] = rec
            line["recall_at_10"] = rec = recall(
                ids, want_wire if oracle is None else oracle)
        emit(line)
        results[label] = result
        if rec < RECALL_GATE:
            raise AssertionError(f"{label}: recall@10 {rec} < {RECALL_GATE}")
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected {expect}")
        return line, ids

    def drive_clf(label, expect, reps=3, oracle=None, **kw):
        clf = KNNClassifier(k=K, device="cuda", **kw).fit(X, y)

        def run():
            report = clf.loo_report()
            return report.result, report.matches

        return drive(label, run, lambda: clf.kneighbors(None),
                     lambda: all_knn(Xd, config=clf.config, device=device),
                     expect, wire_oracle=clf.config.ring_transfer_dtype == "int8",
                     reps=reps, oracle=oracle)

    launches, ids_of, results = {}, {}, {}
    for variant, kname in (("tiles", "fused_knn_tiles"),
                           ("sweep", "fused_knn_sweep")):
        for policy, suffix in (("exact", ""), ("mixed", "[compress]")):
            label = f"pallas/{variant}/{policy}"
            # the compress kernels stage queries and corpus (2 prologue
            # launches); the exact ones the corpus once, whose first rows
            # are the queries (1)
            stage = "stage_bf16" if suffix else "stage_tf32_split"
            expect = {kname + suffix: 1, stage: 1 if stage == "stage_tf32_split" else 2}
            line, ids_of[label] = drive_clf(
                label, expect, backend="pallas", pallas_variant=variant,
                precision_policy=policy)
            launches[kname + suffix] = line["launches"][kname + suffix]
            if variant == "tiles":
                launches[stage] = line["launches"][stage]
    drive_clf("serial/exact", {}, backend="serial")

    # the exact fused ring on cards moves its blocks with K4 (one launch per
    # card per round, P=1 included); bidir and mixed keep the driver's
    # transport with K3a/K3b
    ring_p1 = [("exact", None, "fused_round_dma"),
               ("mixed", None, "fused_block_merge[compress]"),
               ("mixed", "int8", "fused_block_merge[compress]")]
    for policy, wire, kname in ring_p1:
        label = f"ring-overlap/fused/P1/{policy}/{wire or 'float32'}"
        # the queries and the block are staged once: 2 prologue launches (K4
        # on the f32 wire: its own prologue, planes and norms)
        stage = "stage_bf16[wire]" if policy == "mixed" else "stage_tf32_split[ring]"
        expect = {kname: 1, stage: 2}
        line, ids_of[label] = drive_clf(
            label, expect, backend="ring-overlap", ring_fusion="fused",
            num_devices=1, precision_policy=policy, ring_transfer_dtype=wire)
        if wire is None and policy == "mixed":
            launches[stage] = line["launches"][stage]
            launches[kname] = line["launches"][kname]

    def drive_mesh(label, cfg, expect, reps=3, oracle=None):
        def run():
            res = all_knn(X, config=cfg, mesh=mesh, device=device)
            return res, int(knn_classify(res, y).matches(y))

        return drive(
            label, run, lambda: all_knn(X, config=cfg, mesh=mesh, device=device),
            lambda: all_knn(Xd, config=cfg, mesh=mesh, device=device), expect,
            reps=reps, oracle=oracle)

    # the exact fused rings stage each rank's queries and block once: 8
    # prologue launches (K4's own on the dma form, stage_tf32[wire] else)
    norms8 = {"stage_tf32[wire]": 8}
    planes8 = {"stage_tf32_split[ring]": 8}
    for schedule, fusion, expect in (
            ("uni", "fused", {"fused_round_dma": 4 * cards, **planes8}),
            ("bidir", "fused", {"fused_block_merge[exact]": 16, **norms8}),
            ("uni", "xla", {})):
        cfg = KNNConfig(k=K, backend="ring-overlap", ring_schedule=schedule,
                        ring_fusion=fusion)
        label = f"ring-overlap/{fusion}/P4/exact/{schedule}"
        line, ids_of[label] = drive_mesh(label, cfg, expect)
        if schedule == "bidir":
            for name in ("fused_block_merge[exact]", "stage_tf32[wire]"):
                launches[name] = line["launches"][name]
        elif fusion == "fused":
            launches["stage_tf32_split[ring]"] = line["launches"]["stage_tf32_split[ring]"]

    # the ring's in-kernel transport: K4 each round, K5 the whole rotation;
    # each must equal the driver-transport K3a ring on the same inputs
    k3a_ring = ring.all_knn_ring(Xc, Xc, row_ids, KNNConfig(
        k=K, backend="ring-overlap", ring_fusion="fused"), mesh=mesh,
        device=device, form="driver")
    for rotation, kname, expect in (
            ("round", "fused_round_dma", {"fused_round_dma": 4 * cards, **planes8}),
            ("grid", "fused_rotation_grid", {"fused_rotation_grid": cards,
                                             **norms8})):
        cfg = KNNConfig(k=K, backend="ring-overlap", ring_fusion="fused",
                        ring_fused_rotation=rotation)
        label = ("ring-overlap/fused-"
                 f"{'dma' if rotation == 'round' else 'grid'}/P4/exact/uni")
        line, ids_of[label] = drive_mesh(label, cfg, expect)
        launches[kname] = line["launches"][kname]
        res = results[label]
        same = (torch.equal(res.ids, k3a_ring[1])
                and torch.equal(res.dists, k3a_ring[0]))
        emit({"phase": "transport_vs_driver", "path": label,
              "bitwise_equal_to_k3a_ring": same})
        if not same:
            raise AssertionError(f"{label}: differs from the driver-transport "
                                 "K3a ring")

    # the resumable ring: stopped after 2 of 4 rounds, then resumed from its
    # checkpoint; K4 every round that moves the block, K3a in the last one
    dma_label = "ring-overlap/fused-dma/P4/exact/uni"
    cfg = KNNConfig(k=K, backend="ring-overlap", ring_fusion="fused")
    with tempfile.TemporaryDirectory() as ckpt:
        reset_counts()
        all_knn_ring_resumable(X, X, row_ids, cfg, mesh=mesh, device=device,
                               checkpoint_dir=ckpt, stop_after_rounds=2)
        sync_all()
        first = {k: v for k, v in read_counts().items() if v}
        reset_counts()
        t0 = time.perf_counter()
        d, i = all_knn_ring_resumable(X, X, row_ids, cfg, mesh=mesh,
                                      device=device, checkpoint_dir=ckpt)
        sync_all()
        resume_s = time.perf_counter() - t0
        second = {k: v for k, v in read_counts().items() if v}
    same = (torch.equal(i, results[dma_label].ids)
            and torch.equal(d, results[dma_label].dists))
    expect_first = {"fused_round_dma": 2 * cards, **planes8}
    expect_second = {"fused_round_dma": cards, "fused_block_merge[exact]": 4,
                     **planes8}
    emit({"phase": "resume", "path": "all_knn_ring_resumable/P4/exact/uni",
          "stopped_after_rounds": 2, "launches_first": first,
          "launches_resumed": second, "resumed_s": resume_s,
          "bitwise_equal_to_one_shot": same})
    if not same:
        raise AssertionError("resumed ring differs from the one-shot ring")
    if first != expect_first or second != expect_second:
        raise AssertionError(f"resume launches {first} / {second}, expected "
                             f"{expect_first} / {expect_second}")

    # the exact ring must find the exact fused path's neighbours (by f64
    # distance, tie-aware) on the sampled rows
    ref = ids_of["pallas/tiles/exact"][sample]
    ref_d = true_keys(Xcd[sample], Xcd, ref)
    for label, ids in ids_of.items():
        if not label.startswith("ring") or "/exact" not in label:
            continue
        got = ids[sample]
        got_d = true_keys(Xcd[sample], Xcd, got)
        in_set = (got[:, :, None] == ref[:, None, :]).any(-1)
        kth = ref_d[:, -1:]
        scale = 2.0 * (Xcd[sample].double() ** 2).sum(1, keepdim=True)
        tie = got_d <= kth + 1e-5 * kth + 1e-4 * scale
        agree = float((in_set | tie).float().mean())
        emit({"phase": "ring_vs_fused", "path": label, "rows": SAMPLE_ROWS,
              "id_agreement": agree})
        if agree < AGREEMENT_GATE:
            raise AssertionError(f"{label}: agreement with the fused path {agree}")

    mark("main_paths")
    # ---- matmul_precision "default" / "high" on the main paths: the pallas
    # kernels (one norms prologue, one kernel) and the 4-rank fused rings
    # (K4 each round, K3a bidir, K5), one timed rep each; recall@10 >=
    # RECALL_GATE against the oracle of the operands the precision
    # multiplies (the precision's own loss is not the kernels': the input
    # data's recall is printed beside, as for the int8 wire)
    c32 = Xc.astype(np.float64)
    for precision in PRECISIONS:
        rounded = serve_oracle(c32[sample256], c32, precision=precision,
                               self_rows=sample256)
        for variant, kname in (("tiles", "fused_knn_tiles"),
                               ("sweep", "fused_knn_sweep")):
            name = f"{kname}[{precision}]"
            line, _ = drive_clf(f"pallas/{variant}/exact/{precision}",
                                {name: 1, "stage_norms": 1}, reps=1, oracle=rounded,
                                backend="pallas", pallas_variant=variant,
                                matmul_precision=precision)
            launches[name] = line["launches"][name]
            launches["stage_norms"] = line["launches"]["stage_norms"]
        for form, kw, name, count in (
                ("fused-dma", {}, f"fused_round_dma[{precision}]", 4 * cards),
                ("fused/bidir", {"ring_schedule": "bidir"},
                 f"fused_block_merge[{precision}]", 16),
                ("fused-grid", {"ring_fused_rotation": "grid"},
                 f"fused_rotation_grid[{precision}]", cards)):
            cfg = KNNConfig(k=K, backend="ring-overlap", ring_fusion="fused",
                            matmul_precision=precision, **kw)
            line, _ = drive_mesh(f"ring-overlap/{form}/P4/exact/{precision}", cfg,
                                 {name: count, **norms8}, reps=1, oracle=rounded)
            launches[name] = line["launches"][name]

    # an exact duplicate pair (3, 7) and a near-twin (11, 42) at d^2 = 64
    # under each precision: the pair's rank and d^2 in row 3 (-1: dropped by
    # the zero rule, which is calibrated for "highest"); the twin must stay
    # first
    for precision in PRECISIONS:
        for label, kw in (("pallas/tiles", dict(backend="pallas")),
                          ("ring/P4/fused-dma", dict(backend="ring-overlap",
                                                     ring_fusion="fused", mesh=mesh4))):
            res = all_knn(Xdup, k=K, matmul_precision=precision, device=device, **kw)
            ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
            rank = ids[3].tolist().index(7) if 7 in ids[3] else -1
            ok = ids[11][0] == 42 and ids[42][0] == 11
            emit({"phase": "precision_duplicates", "path": label,
                  "precision": precision, "pair_rank": rank,
                  "pair_d2": float(dists[3][rank]) if rank >= 0 else None,
                  "pair_q2_plus_c2": float(2 * (dup_c[3] ** 2).sum()),
                  "twin_d2": float(dists[11][0]), "twin_first": bool(ok)})
            if not ok:
                raise AssertionError(f"{precision} {label}: the near-twin is not first")

    # the f64 bin minimum on a main path: serial twolevel at dtype float64,
    # approx (one launch per tile), recall@10 against the f64 oracle
    cfg64 = KNNConfig(k=K, backend="serial", dtype="float64", topk_method="approx")
    reset_counts()
    res64 = all_knn(Xd, config=cfg64, device=device)
    sync_all()
    counts = {k: v for k, v in read_counts().items() if v}
    _, ms64, s64 = median_ms(lambda: all_knn(Xd, config=cfg64, device=device), 1)
    tiles64 = -(-M_FULL // 1024) * -(-M_FULL // 2048)
    rec64 = recall(res64.ids)
    emit({"phase": "main_path", "path": "serial/twolevel/approx/float64", "m": M_FULL,
          "d": D, "k": K, "device_input_ms_median": ms64, "device_input_s_reps": s64,
          "recall_at_10": rec64, "recall_gate": RECALL_TARGET, "launches": counts,
          "dists_dtype": str(res64.dists.dtype)})
    if counts != {"approx_min_k[f64]": tiles64}:
        raise AssertionError(f"f64 approx: launches {counts}, expected {tiles64}")
    if rec64 < RECALL_TARGET or res64.dists.dtype != torch.float64:
        raise AssertionError(f"f64 approx: recall@10 {rec64} or dtype {res64.dists.dtype}")
    launches["approx_min_k[f64]"] = counts["approx_min_k[f64]"]
    del res64

    mark("precision_main_paths_and_f64")
    # ---- query serving: the resident index, the engine, three variants ---
    inputs = serve_inputs(device, X)
    for name, err in serve_phase(device, X, inputs).items():
        max_err[name] = max(max_err[name], err)
    serve_ring_phase(device, X, inputs)

    mark("serve_and_serve_ring")
    # ---- the reference's own data path and run CLI, at full width ---------
    launches["approx_min_k"] = run_cli_phase(device, X, y)
    mark("run_cli")
    # ---- the clustered (IVF) index at the README's deployment -------------
    ivf_phase(device)
    mark("ivf")
    max_err["approx_min_k"] = max(e["max_abs_err"] for c, e in approx.items()
                                  if "f64/" not in c)
    max_err["approx_min_k[f64]"] = max(e["max_abs_err"] for c, e in approx.items()
                                       if "f64/" in c)
    # the yardstick of the "default" / "high" forms: the serial backend at
    # that precision on the same card inputs
    for precision in PRECISIONS:
        cfg = KNNConfig(k=K, backend="serial", matmul_precision=precision)

        def serial_p():
            return all_knn_serial(Xcd, Xcd, row_ids, cfg, device)  # noqa: B023

        serial_p()  # warm-up
        library[("serial", precision)] = cuda_ms(serial_p, reps=1)
        emit({"phase": "library_time", "call": "backends.serial.all_knn_serial",
              "matmul_precision": precision, "m": M_FULL, "d": D, "k": K,
              "ms": library[("serial", precision)]})

    replaces = {
        "fused_knn_tiles": "mpi_knn_tpu/ops/pallas_knn.py:249",
        "fused_knn_sweep": "mpi_knn_tpu/ops/pallas_knn.py:330",
        "fused_knn_tiles[compress]": "mpi_knn_tpu/ops/pallas_knn.py:249",
        "fused_knn_sweep[compress]": "mpi_knn_tpu/ops/pallas_knn.py:330",
        "fused_block_merge[exact]": "mpi_knn_tpu/ops/pallas_ring.py:337",
        "fused_block_merge[compress]": "mpi_knn_tpu/ops/pallas_ring.py:363",
        "fused_round_dma": "mpi_knn_tpu/ops/pallas_ring.py:553",
        "fused_rotation_grid": "mpi_knn_tpu/ops/pallas_ring.py:806",
        # the prologues: the norms of the exact tiles, and the bf16 casts
        # and norms of the compress tiles, hoisted out of the tile
        "stage_tf32_split": "mpi_knn_tpu/ops/pallas_knn.py:249",
        "stage_tf32[wire]": "mpi_knn_tpu/ops/pallas_ring.py:337",
        "stage_tf32_split[ring]": "mpi_knn_tpu/ops/pallas_ring.py:553",
        "stage_bf16": "mpi_knn_tpu/ops/pallas_knn.py:249",
        "stage_bf16[wire]": "mpi_knn_tpu/ops/pallas_ring.py:363",
        # not a Pallas site: the TPU partial reduction XLA lowers
        "approx_min_k": "mpi_knn_tpu/ops/topk.py:156,176 (lax.approx_min_k)",
        # matmul_precision "default" / "high" (the reference's precision
        # argument of the same Pallas sites), and their norms prologue
        **{f"{base}[{p}]": site for p in PRECISIONS for base, site in (
            ("fused_knn_tiles", "mpi_knn_tpu/ops/pallas_knn.py:249"),
            ("fused_knn_sweep", "mpi_knn_tpu/ops/pallas_knn.py:330"),
            ("fused_block_merge", "mpi_knn_tpu/ops/pallas_ring.py:337"),
            ("fused_round_dma", "mpi_knn_tpu/ops/pallas_ring.py:553"),
            ("fused_rotation_grid", "mpi_knn_tpu/ops/pallas_ring.py:806"))},
        "stage_norms": "mpi_knn_tpu/ops/pallas_knn.py:249",
        "approx_min_k[f64]": "mpi_knn_tpu/ops/topk.py:156,176 (lax.approx_min_k, f64)",
    }
    library_of = {
        "fused_knn_tiles": library[("serial", "exact")],
        "fused_knn_sweep": library[("serial", "exact")],
        "fused_knn_tiles[compress]": library[("serial", "mixed")],
        "fused_knn_sweep[compress]": library[("serial", "mixed")],
        "fused_block_merge[exact]": library[("xla_round", "exact")],
        "fused_block_merge[compress]": library[("xla_round", "mixed")],
        "fused_round_dma":
            transport_timing[("fused_round_dma", "p4_round")]["library_ms"],
        "fused_rotation_grid":
            transport_timing[("fused_rotation_grid", "p4_rotation")]["library_ms"],
        "stage_tf32_split": None,  # no one PyTorch call writes the planes and norms
        "stage_tf32[wire]": timing["stage_tf32[wire]"]["library_ms"],
        "stage_tf32_split[ring]": None,  # no one PyTorch call writes the planes and norms
        "stage_bf16": None,  # no one PyTorch call writes the copy and the norms
        "stage_bf16[wire]": None,
        # torch.topk computes the exact function the method approximates
        "approx_min_k": approx["fused/tile_k10"]["topk_ms"],
        **{f"{base}[{p}]": library[("serial", p)] for p in PRECISIONS
           for base in ("fused_knn_tiles", "fused_knn_sweep", "fused_block_merge",
                        "fused_round_dma", "fused_rotation_grid")},
        "stage_norms": timing["stage_norms"]["library_ms"],
        "approx_min_k[f64]": approx["fused/f64/tile_k10"]["topk_ms"],
    }
    times = {**timing, **{name: ring_timing[(name, "p1_mnist60k")]
                          for name in merge_modes},
             "fused_round_dma": transport_timing[("fused_round_dma", "p4_round")],
             "fused_rotation_grid":
                 transport_timing[("fused_rotation_grid", "p4_rotation")],
             # the serial twolevel tile, where the approx main path launches
             # it (the fused form, as smallest_k calls it)
             "approx_min_k": approx["fused/tile_k10"],
             **{f"fused_block_merge[{p}]": ring_timing[(f"fused_block_merge[{p}]",
                                                        "p1_mnist60k")]
                for p in PRECISIONS},
             **{f"fused_round_dma[{p}]": transport_timing[(f"fused_round_dma[{p}]",
                                                           "p4_round")]
                for p in PRECISIONS},
             **{f"fused_rotation_grid[{p}]": transport_timing[
                 (f"fused_rotation_grid[{p}]", "p4_rotation")] for p in PRECISIONS},
             "approx_min_k[f64]": approx["fused/f64/tile_k10"]}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "mpi_knn_tpu_torch/csrc/" + source_of(name),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": library_of[name]}
        for name in replaces
    ]})
    mark("kernels_line")
    emit({"phase": "total_seconds", "seconds": marks[-1][1] - marks[0][1]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

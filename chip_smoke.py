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
6. approx_kernel (run right after the build): the bin-minimum kernel that
   replaces the TPU's ``lax.approx_min_k`` against its plain version, bit
   for bit in values and positions, at the main path's shapes (the serial
   1024x2048 tile with k 10 and 4k = 40 raw, the stream step's 1024x2176,
   the pallas tiles' 60416x384 merge), k = 1, planted ties and +inf
   padding; each timed beside its plain version, torch.topk and its bound;
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
8. kernels: one line with every kernel mode's launches, error, times and
   bound, the prologues (`stage_tf32_split`, `stage_tf32[wire]`,
   `stage_tf32_split[ring]`, `stage_bf16`, `stage_bf16[wire]`) and the
   approx kernel among them.

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
    if kernel == "approx_min_k":
        return "approx_topk.cu"
    if kernel.startswith("fused_knn") or kernel in ("stage_tf32_split", "stage_bf16"):
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


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, by CUDA
    events, the calls queued behind a spin kernel so that the host's time
    to issue them stays out: for calls that do not synchronize and take
    longer on the host than on the card. Raises if the host took longer to
    issue them than the spin lasted."""
    import torch

    spun = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spun.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    issue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if issue_ms >= spun.elapsed_time(start):
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


def true_keys(q, c, ids, compress=False, clamp=True, mask=None):
    """f64 key of every (row r, id) of ``ids`` (R, L) from the inputs alone:
    ||q_r - c_id||^2, or in compress mode q^2 - 2 bf16(q).bf16(c) + c^2
    (max 0 when ``clamp``). inf where id < 0 or ``mask(rows, ids)``. In row
    chunks of ~2^26 values."""
    import torch

    out = torch.full(ids.shape, float("inf"), dtype=torch.float64,
                     device=ids.device)
    rows = max(1, (1 << 26) // (ids.shape[1] * q.shape[1]))
    for r0 in range(0, ids.shape[0], rows):
        idc = ids[r0:r0 + rows]
        qr, cr = q[r0:r0 + rows, None, :], c[idc.clamp_min(0).long()]
        if compress:
            b = torch.bfloat16
            dot = (qr.to(b).double() * cr.to(b).double()).sum(-1)
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
            span, compress=False, sample=None) -> float:
    """Hold a kernel's (dists, ids) against its plain version's; returns the
    largest absolute distance difference over finite slots. Each sorted
    list of k is compared on its own (a tiles kernel emits one per query
    and corpus tile of ``span`` columns). The f64 checks run on the rows
    of ``sample`` when given, else on every row."""
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
    true_g = true_keys(q, c, gi, compress=compress)
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


def serve_phase(device, X) -> dict:
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
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import fused_knn
    from mpi_knn_tpu_torch.ops.distance import center_for_l2
    from mpi_knn_tpu_torch.serve import engine
    from mpi_knn_tpu_torch.utils.report import recall_at_k

    t_phase = time.perf_counter()
    Qs, _ = make_mnist_like(SERVE_QUERIES, seed=1)
    Qs[DUP_QUERY] = X[DUP_ROW]
    streams = serve_streams()
    # all_knn's own host centering (f64 mean and subtraction), once: the
    # reference calls get the same f32 rows with center=False
    Xc64, Qc64 = center_for_l2(X, Qs, all_pairs=False)
    Xc_dev = torch.from_numpy(Xc64).to(torch.float32).to(device)
    Qc_dev = torch.from_numpy(Qc64).to(torch.float32).to(device)
    # the f64 oracle of 256 sampled queries (the duplicate among them):
    # the zero rule d <= 1e-6 (q^2 + c^2) on the centered rows, ties to the
    # lower id
    picks = np.unique(np.r_[np.linspace(0, SERVE_QUERIES - 1, 255).astype(int),
                            DUP_QUERY])
    q, c = Qc64[picks], Xc64
    q_sq, c_sq = (q ** 2).sum(1)[:, None], (c ** 2).sum(1)[None, :]
    d = q_sq + c_sq - 2.0 * (q @ c.T)
    d[d <= 1e-6 * (q_sq + c_sq)] = np.inf
    want_ids = np.argsort(d, axis=1, kind="stable")[:, :K]
    del d
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


# the approximate top-k kernel's shapes: (case, rows, columns, k, aggregate);
# the serial twolevel tile (approx: k, approx-rerank: 4k raw), the stream
# step's carry + tile padded to 2176, the pallas tiles' cross-tile merge of
# 30 x 10 survivors padded to 384, and the edge rows
APPROX_CASES = (("tile_k10", 1024, 2048, K, True),
                ("tile_rerank", 1024, 2048, OV, False),
                ("stream_k10", 1024, 2176, K, True),
                ("stream_rerank", 1024, 2176, OV, False),
                ("merge_k10", 60416, 384, K, True),
                ("k1", 1024, 2048, 1, True),
                ("planted_ties", 1024, 2048, K, True),
                ("inf_padding", 1024, 2176, K, True))
RECALL_TARGET = 0.95  # the config's default, which the run_cli phase uses
# serial stream approx-rerank, recall over all 60000 rows: the card read
# 0.99816-0.99842 on seeds 0-4 of make_mnist_like (0.99840 on seed 0, the
# smoke's; tools/approx_recall.py), its recall_target is 0.95; a path that
# lost twice the neighbours would read about 0.9968
STREAM_RERANK_GATE = 0.997


def approx_kernel_phase(device) -> dict:
    """The bin-minimum kernel against its plain version on the card, bit
    for bit (values and positions) at every case of APPROX_CASES; each timed
    (device times of the kernel, of the plain version and of torch.topk on
    the same rows, the exact function the method approximates, means of 20
    calls queued behind a spin; the wrapper's call by CUDA events alone,
    mean of 3) beside its bound
    (the rows read once and the (value, position) pairs written once at
    the HBM rate; one compare a column at the FP32 rate). Returns
    {case: entry}."""
    import torch

    from mpi_knn_tpu_torch.ops import approx_topk

    rng = np.random.default_rng(21)
    out = {}
    for case, rows, n, k, aggregate in APPROX_CASES:
        if case == "planted_ties":  # a few values, each column tied many times
            x = rng.integers(0, 6, (rows, n)).astype(np.float32)
        else:  # squared distances
            x = rng.standard_normal((rows, n)).astype(np.float32) ** 2
        if case == "inf_padding":  # the stream step's lane padding
            x[:, 2058:] = np.inf
            x[7] = np.inf
        d = torch.from_numpy(x).to(device)
        L = approx_topk.reduction_width(n, k, RECALL_TARGET)
        width = k if aggregate else L
        call = lambda: approx_topk.approx_min_k(d, k, RECALL_TARGET, aggregate)  # noqa: E731
        plain = lambda: approx_topk.approx_min_k_reference(  # noqa: E731
            d, k, RECALL_TARGET, aggregate)
        (gv, gp), (wv, wp) = call(), plain()
        torch.cuda.synchronize()
        same = torch.equal(gp, wp) and torch.equal(gv.view(torch.int32),
                                                   wv.view(torch.int32))
        topk = lambda: torch.topk(d, k, dim=-1, largest=False)  # noqa: E731
        topk()
        t_bytes = (4.0 * rows * n + 12.0 * rows * width) / PEAK_BYTES_PER_S
        t_ops = float(rows * n) / PEAK_FP32_FLOPS
        entry = {"rows": rows, "n": n, "k": k, "aggregate_to_topk": aggregate,
                 "L": L, "out": width, "bitwise_equal": same,
                 "max_abs_err": float((gv - wv).abs().nan_to_num(0.0).max()),
                 "ms": queued_ms(call, 20), "call_ms": cuda_ms(call, reps=3),
                 "plain_ms": queued_ms(plain, 20), "topk_ms": queued_ms(topk, 20),
                 "bound_ms": 1e3 * max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit({"phase": "approx_kernel", "case": case, **entry})
        if not same:
            raise AssertionError(f"approx_min_k/{case}: differs from its plain version")
        out[case] = entry
        del d, gv, gp, wv, wp
    return out


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
    for name, checks in kernel_fns.items():
        lib = mma[source_of(name).removesuffix(".cu")]
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
    del qp, cp, staged, qb, cb, split

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

    def median_ms(fn):
        times = []
        for _ in range(3):
            sync_all()
            t0 = time.perf_counter()
            out = fn()
            sync_all()
            times.append(time.perf_counter() - t0)
        return out, 1e3 * statistics.median(times), times

    def drive(label, run, host, dev_input, expect, wire_oracle=False):
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
        res, host_ms, host_s = median_ms(host)
        _, dev_ms, dev_s = median_ms(dev_input)
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
        if wire_oracle:
            line["recall_at_10_input_data"] = rec
            line["recall_at_10"] = rec = recall(ids, want_wire)
        emit(line)
        results[label] = result
        if rec < RECALL_GATE:
            raise AssertionError(f"{label}: recall@10 {rec} < {RECALL_GATE}")
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected {expect}")
        return line, ids

    def drive_clf(label, expect, **kw):
        clf = KNNClassifier(k=K, device="cuda", **kw).fit(X, y)

        def run():
            report = clf.loo_report()
            return report.result, report.matches

        return drive(label, run, lambda: clf.kneighbors(None),
                     lambda: all_knn(Xd, config=clf.config, device=device),
                     expect, wire_oracle=clf.config.ring_transfer_dtype == "int8")

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

    def drive_mesh(label, cfg, expect):
        def run():
            res = all_knn(X, config=cfg, mesh=mesh, device=device)
            return res, int(knn_classify(res, y).matches(y))

        return drive(
            label, run, lambda: all_knn(X, config=cfg, mesh=mesh, device=device),
            lambda: all_knn(Xd, config=cfg, mesh=mesh, device=device), expect)

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

    # ---- query serving: the resident index, the engine, three variants ---
    for name, err in serve_phase(device, X).items():
        max_err[name] = max(max_err[name], err)

    # ---- the reference's own data path and run CLI, at full width ---------
    launches["approx_min_k"] = run_cli_phase(device, X, y)
    max_err["approx_min_k"] = max(e["max_abs_err"] for e in approx.values())

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
        "approx_min_k": approx["tile_k10"]["topk_ms"],
    }
    times = {**timing, **{name: ring_timing[(name, "p1_mnist60k")]
                          for name in merge_modes},
             "fused_round_dma": transport_timing[("fused_round_dma", "p4_round")],
             "fused_rotation_grid":
                 transport_timing[("fused_rotation_grid", "p4_rotation")],
             # the serial twolevel tile, where the approx main path launches it
             "approx_min_k": approx["tile_k10"]}
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
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mpi_knn_tpu_torch).

    python3 chip_smoke.py        # needs one CUDA card; builds csrc/ with nvcc
    python3 chip_smoke.py --multiproc-cards   # four cards: the 2 x 2 pod timed,
                                              # and told apart into two hosts

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
   against the serial backend. The capacity planner (``plan.py``) on the
   float32 store, the allocator's peak reset before its build: the
   predicted bucket_cap at least the built one, the predicted peak at
   least the ``max_memory_allocated`` growth over the build (nprobe
   tuned), the one-shot search and serving, the served q/s at most the
   roofline's, the recall at least the predicted minus 0.01; the profile's
   figures beside the card's (``total_memory``, a 1 GiB copy's bytes/s,
   peer or on the card); then ``plan`` for the README deployment through
   the package's CLI (exit 0, the H100 profile), its emitted
   ``build-index`` and ``serve`` run as emitted (the serve with a port and
   ready file appended), ``/healthz`` naming the H100 profile and a peak
   at or under the plan's; the same for ``plan --backend ivf``, the two
   deployments side by side. No kernel of the port runs on this path (its
   launch counts stay 0): no Pallas site lies on the JAX package's;
11. mutate (``mutate_phase``): live mutation at the README's mutable
   deployment (that corpus with ``bucket_headroom=0.5``,
   ``mutation_bucket=128``; float32 and int8 stores; 128-row chunks under
   new ids from 1000000; 512-row batches of the held-out queries): every
   live row upserted again under its own id keeps the store bit for bit;
   the store tensors keep their storage and an upsert + delete's peak
   allocation grows by at most 8 chunk sizes; upsert and delete rows/s
   (median of 16 cycles); serving p50 / p99 quiesced and beside a churning
   thread (every batch finite, none returning an id deleted before its
   submission); after churn of 10 % new rows and 10 % deletes, each
   upserted row its own first neighbour, no deleted id returned, recall@10
   against f64 over the live rows at least a fresh build's minus 0.02, a
   rebuild per batch at least 10x an upsert chunk; compaction retrained
   twice from one state gives the same bits, its seconds with and without
   retraining, and (float32) nprobe = partitions equals serial over the
   live rows. No kernel runs on this path (its launch counts stay 0);
12. ops (``ops_phase``): the serving session's operations layer at the
   serve phase's deployment (its pallas tiles exact index, 256-row
   batches) and the ``ivf`` phase's: transient faults retried with the
   fixed backoff, bit for bit; retries exhausted; the NaN sentinel with the
   batch's provenance; the degradation ladder walked under injected slow
   batches (pallas full -> mixed -> bucket/512, IVF full -> nprobe/1 ->
   mixed -> bucket/512), every walked batch bit for bit a session at its
   rung, nothing built after warm, K1 and K1[c] launched; the registry's
   counters equal to the session's own and its Prometheus text re-parsed;
   the flight records valid; three restarted children on one persistent
   kernel cache (cold: each library they load built by nvcc and stored;
   warm: none built; a truncated entry: rebuilt loudly), their results bit for bit
   and their seconds to the first answer; the doctor on the card (its
   plan line ok: the tiny corpus's predicted peak over the K1 probe's
   measured one) and with an injected hang (its supervisor never
   initializes CUDA); then
   timed windows with and without a policy and a flight record, and each
   rung's q/s, p99 and recall@10;
13. frontend (``frontend_phase``): the serving front end at the serve
   phase's deployment under a policy: a Frontend and its HTTP server on
   port 0, a checked pass of 16- and 256-row requests from 8 tenants at
   once, bit for bit the session alone and recall@10 = 1.0, then
   ``loadgen`` at three offered rates of each size (q/s, p50/p99 beside
   the session alone) and the batch fill histogram, K1 and its prologue
   launched; an overload burst under injected slow batches shed to the
   mixed rung (K1[c] launched) and recovered, with the lags; online
   mutation over HTTP and through ``mutate --url`` on a serial index (a
   409 on a sequence gap); ``router --spawn 2`` as a process over the
   warm kernel cache the ops phase left: its answers bit for bit the
   front end's, ``loadgen`` through it and against one replica, a
   replica SIGKILLed under load (no client error) rejoining with its
   mutation sequence caught up by replay;
14. profile (``profile_phase``): ``ServeSession.profile`` over the serve
   cell's pallas tiles exact index and its mixed rung (8 batches of 256
   rows each), one P=4 fused-dma ring batch on the one card, and
   ``attribute_trace`` over the run CLI's ``--profile`` trace of a serial
   twolevel approx run at the main shape: in every window the trace's
   hand-kernel launches equal the port's launch counters, the categories
   sum to the busy total and nothing is built; each window's busy split,
   top ops and busy total against its wall time (the idle share);
15. ivf_sharded (``sharded_phase``): the README's sharded deployment
   (sift:100000, 256 partitions, 4 shards on the one card, 10000 queries,
   512-row batches) per store: S=1 and S=4 bit for bit the unsharded index
   (S=4 at the same query tile, which the exchange buffer's bound picks),
   recall@10 at the clustered cell's bars, a tight route cap's drops
   counted, every served batch bit for bit the one-shot search; a sharded
   upsert / delete chunk against the same writes unsharded; the CLI at the
   visible card count; no kernel launched;
16. mesh2d (``mesh2d_phase``): the main shape on a 2x2 mesh of the one
   card, per transport (Tensor.to with the xla merge, bidir K3a, fused-dma
   K4, grid K5): each dp group's rows bit for bit its 1-D P=2 ring,
   recall@10 >= 0.999, launches the groups' 1-D runs' sum;
17. multiproc (``multiproc_phase``): the main shape through two worker
   processes on the one card (``python chip_smoke.py --multiproc-worker``,
   a gloo process group on a free local port, one ring rank a process, the
   boundary's blocks staged through host memory): fused-dma K4 (its
   boundary copy into an outbox the process group moves), bidir K3a,
   Tensor.to with the xla merge, and the resumable fused-dma ring stopped
   after 1 round into per-process checkpoint directories and resumed.
   Each form bit for bit the single-process P=2 ring on [cuda:0, cuda:0],
   recall@10 >= 0.999, the resumed rounds [2] with only process 0's
   directory holding a file, each process's launches (K4 a round, every
   per-rank kernel half the single process's), the boundary moved once a
   rotating round (each way under bidir; not after the dma form's last
   K4); the device-input ms a process beside the single process's, the
   boundary's bytes and ms an exchange (its D2H and H2D copies' shares),
   the gather's ms and the process group's start-up seconds;
   every worker must exit 0 within its timeout. The same pod's processes
   also drive two ranks each (``multiproc_ranks_gates``: cuda:0 named
   twice in each process, a P=4 ring): fused-dma K4 (in-kernel stores
   between a process's own ranks, the outbox at the boundary), bidir K3a,
   Tensor.to with the xla merge, the grid form K5 (one launch a process;
   the boundary's block streamed into the next process's landing slot
   over CUDA IPC, so the process group moves none), the resumable
   fused-dma ring stopped after 1 round and resumed, and --dp 2 over the
   same four ranks (fused-dma and grid, each group inside one process):
   each bit for bit the single-process P=4 ring on [cuda:0]*4 (--dp: the
   single-process 2x2 mesh), recall@10 >= 0.999, each process's launches
   (K4 and K5 as the single process's, per-rank kernels and --dp half),
   the boundary's moves, and K5's ms a process beside the single
   process's, within a quarter of its waits' bound;
17b. multiproc_hosts (``multiproc_hosts_phase``): the same 2 x 2 pod on
   the one card with each worker reporting a host of its own, so both
   boundary links of every process are proxy links: K5 over the host
   proxy (the last rank's stores into an outbox and a mirror row on its
   card, a proxy thread moving each hop over gloo during the one launch).
   Each process bit for bit the single-process K5 ring and the IPC form,
   recall@10 >= 0.999, 1 K5 launch a process, no CUDA IPC mapping, the
   proxy's bytes 3 hops of block + ids + norms each way, the call within a
   quarter of its waits' bound; device-input ms beside the IPC form's and
   the single process's, and ms a hop by part (copy out, gloo, copy in,
   flag);
18. sharded_mutation (``sharded_mutation_phase``): the sharded store
   mutated, compacted and served across two processes of the one card,
   bit for bit the one-process store;
19. lint (``lint_phase``): ``python -m mpi_knn_tpu_torch lint --device
   cuda --memory --cost`` over the JAX package's 79 cells, in four
   children side by side (``LINT_PARTS``): 0 findings on every cell but
   the 4 refusals (``LINT_SKIPS``), R8's counted FLOPs (the kernels'
   side-band among them) equal to the closed form, R7's trace peak inside
   ``ALLOCATOR_BAND`` of the allocator's growth, one ``lint_scheme`` line
   a scheme; then four cells again at the main path's other settings
   (``LINT_VARIANTS``: the sweep variant exact and mixed, the grid
   rotation, the approximate top-k), the same gates; K1, K2, K1[c],
   K2[c], K3a, K3b, K4, K5, the bin minimum and the prologues launched
   (``lint_launches`` in the kernels line);
20. kernels: one line with every kernel mode's launches, error, times and
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

import concurrent.futures
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


def f64_oracle(corpus, sample, queries=None, rtol=0.0):
    """f64 ids of the k nearest ``corpus`` rows of the rows ``sample`` of
    ``queries`` (default: of ``corpus``): each row's own id excluded
    (leave-one-out), and zero distance (d <= rtol (q^2 + c^2), or d <= 1e-9
    when rtol is 0), ties to the lower id."""
    c = corpus.astype(np.float64)
    q = (c if queries is None else queries.astype(np.float64))[sample]
    q_sq, c_sq = (q ** 2).sum(1)[:, None], (c ** 2).sum(1)[None, :]
    d = q_sq + c_sq - 2.0 * (q @ c.T)
    d[d <= (rtol * (q_sq + c_sq) if rtol else 1e-9)] = np.inf
    d[np.arange(len(sample)), sample] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :K]


def f64_recall(X):
    """The recall@10 yardstick of a leave-one-out run over ``X``: a function
    of a result's ids that reads its 256 evenly spaced rows against
    :func:`f64_oracle` (or against ``want``, ids of those rows)."""
    import torch

    sample = np.linspace(0, len(X) - 1, num=256, dtype=np.int64)
    want_ids = f64_oracle(X, sample)

    def recall(ids, want=want_ids) -> float:
        got = ids[torch.as_tensor(sample, device=ids.device)].cpu().numpy()
        return float((want[:, :, None] == got[:, None, :]).any(-1).mean())

    recall.sample = sample
    return recall


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
    from mpi_knn_tpu_torch.ops import launch_counts

    return launch_counts()


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
                d, i, _ = engine._run(index, cfg, exec_,  # noqa: B023
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
PLAN_PROFILE = "h100-sxm-80gb"  # the planner's profile of this card
PLAN_RECALL_SLACK = 0.01  # measured recall >= predicted - this
PLAN_BOOT_S = 300  # the plan's serve command's limit to answer /healthz
PLAN_COPY_BYTES = 1 << 30  # the profile's copy figure: one 1 GiB copy


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


def plan_profile(device) -> dict:
    """The profile's figures beside the card's: ``total_memory`` against
    ``hbm_bytes``, and a 1 GiB copy's bytes/s (to the second card when the
    machine has one, else on the card: device to device) against
    ``ici_bw``, median of 10 by CUDA events."""
    import torch

    from mpi_knn_tpu_torch.analysis.cost import get_profile

    prof = get_profile(PLAN_PROFILE)
    total = torch.cuda.get_device_properties(device).total_memory
    peer = torch.cuda.device_count() >= 2
    src = torch.empty(PLAN_COPY_BYTES // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src, device=torch.device("cuda", 1) if peer else device)
    times = []
    for rep in range(13):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        dst.copy_(src)
        b.record()
        sync_all()
        if rep >= 3:
            times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    out = {"phase": "plan_profile", "profile": PLAN_PROFILE,
           "total_memory": total, "hbm_bytes_declared": prof["hbm_bytes"],
           "copy": "peer (cuda:0 -> cuda:1)" if peer else "device to device",
           "copy_ms": ms, "copy_bytes_per_s": PLAN_COPY_BYTES / (ms / 1e3),
           "ici_bw_declared": prof["ici_bw"],
           "peak_flops_declared": prof["peak_flops"],
           "hbm_bw_declared": prof["hbm_bw"]}
    emit(out)
    del src, dst
    torch.cuda.empty_cache()
    if prof["hbm_bytes"] > total:
        raise AssertionError(f"plan: the profile budgets {prof['hbm_bytes']} "
                             f"B on a card of {total} B")
    return out


def ivf_plan_check(index, dtype: str, growth: int, rows: int,
                   served: dict | None = None, rec: float | None = None) -> dict:
    """The planner's prediction for one store as the phase built and ran it
    (ivf, 256 partitions, the tuned nprobe, IVF_BATCH-row batches, a
    one-shot search of ``rows`` rows), beside what was measured: bucket_cap
    and the peak on every store; where the store was served, served q/s
    against the roofline and recall against the prediction. The gates of
    ``ivf_phase``'s docstring."""
    from mpi_knn_tpu_torch import plan
    from mpi_knn_tpu_torch.analysis.cost import get_profile

    cand = plan.Candidate("ivf", dtype, partitions=IVF_P, nprobe=index.nprobe)
    wl = plan.Workload(m=IVF_M, d=index.dim, k=K, recall_target=RECALL_TARGET,
                       bucket=IVF_BATCH)
    peak = plan.predict_peak_hbm(cand, wl, tuned_build=True, batch_rows=rows)
    out = {"phase": "ivf_plan", "store": dtype, "profile": PLAN_PROFILE,
           "candidate": {"backend": "ivf", "dtype": dtype,
                         "partitions": IVF_P, "nprobe": index.nprobe,
                         "batch": IVF_BATCH, "one_shot_rows": rows},
           "bucket_cap": {"predicted": plan.bucket_cap_for(IVF_M, IVF_P, 0.0),
                          "built": index.bucket_cap},
           "peak_bytes": {"predicted": peak["peak_hbm_bytes"],
                          "measured_growth": growth,
                          "measured_over_predicted": growth / peak["peak_hbm_bytes"],
                          "stages": peak["stages"]}}
    ok = (out["bucket_cap"]["predicted"] >= index.bucket_cap
          and peak["peak_hbm_bytes"] >= growth)
    if served is not None:
        roof = plan.predict_qps(cand, wl, get_profile(PLAN_PROFILE))
        out["qps"] = {"roofline": roof["qps"], "bound": roof["bound"],
                      "served": served["qps"]}
        ok = ok and served["qps"] <= roof["qps"]
    if rec is not None:
        calib = plan.load_calibration()
        fraction = index.nprobe / IVF_P
        recall = plan.predict_recall(fraction, dtype, calib)
        out["recall_at_10"] = {
            "predicted": recall, "measured": rec,
            # below the smallest calibrated fraction the planner plans no
            # nprobe; the prediction there is the model's extrapolation
            "within_calibration": fraction >= calib["points"][0][0]}
        ok = ok and rec >= recall - PLAN_RECALL_SLACK
    emit(out)
    if not ok:
        raise AssertionError(f"ivf {dtype}: the planner's prediction misses: {out}")
    return out


def ivf_peak_bfloat16(X, Q, device) -> dict:
    """The bfloat16 store's peak against the planner's (the one at-rest
    dtype the phase does not serve): the allocator's peak reset, the build
    (nprobe tuned) and one one-shot search of Q."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    index = build_ivf_index(X, KNNConfig(k=K, partitions=IVF_P, dtype="bfloat16"),
                            device=device)
    d, i = search_ivf(index, Q, device=device)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(d).all()) or bool((i < 0).any()):
        raise AssertionError("ivf bfloat16: non-finite results")
    out = ivf_plan_check(index, "bfloat16",
                         torch.cuda.max_memory_allocated(device) - base, len(Q))
    del index, d, i
    torch.cuda.empty_cache()
    return out


# the planner runs in this process with its stdout redirected, which is
# process-wide: the two plans of the ivf phase take turns, their children
# run together
PLAN_STDOUT_LOCK = threading.Lock()


def plan_cli(tmp, restrict, queries, od, oi) -> dict:
    """``plan`` for the README deployment through the package's CLI (with
    ``restrict``'s search-space flags appended), then its emitted commands
    as emitted: ``build-index`` where the plan has one, and ``serve`` with
    ``--port 0 --ready-file`` appended (the smoke's rendezvous). Gates: the
    built store's bucket_cap within the plan's, ``/healthz`` naming the
    H100 profile and a peak at or under the plan's, and the served
    store's recall@10 on ``queries`` (the phase's oracle rows, tie-aware
    against ``od`` / ``oi``) at least the plan's prediction -
    PLAN_RECALL_SLACK; then the server is stopped."""
    import contextlib
    import io
    import shlex
    import urllib.request

    from mpi_knn_tpu_torch import cli
    from mpi_knn_tpu_torch.ivf import load_ivf_index

    argv = ["plan", "--corpus", str(IVF_M), "--dim", "128", "--k", str(K),
            "--recall-target", "0.95", "--devices", "1", *restrict]
    buf = io.StringIO()
    with PLAN_STDOUT_LOCK, contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--data", f"sift:{IVF_M}", "--index-out",
                              os.path.join(tmp, "plan.ivf.npz"), "-q"])
    doc = json.loads(buf.getvalue()) if rc == 0 else {}
    if rc != 0 or doc["fleet"]["profile"] != PLAN_PROFILE:
        raise AssertionError(f"plan_cli: plan exited {rc}: {buf.getvalue()}")
    pred, cmds = doc["predicted"], doc["commands"]
    build_s = cap = None
    if "build_index" in cmds:
        t0 = time.perf_counter()
        built = subprocess.run(shlex.split(cmds["build_index"]),
                               capture_output=True, text=True, timeout=PLAN_BOOT_S)
        build_s = time.perf_counter() - t0
        if built.returncode != 0:
            raise AssertionError(f"plan_cli: build-index: {built.stderr[-2000:]}")
        cap = load_ivf_index(os.path.join(tmp, "plan.ivf.npz"),
                             device="cpu").bucket_cap
    elif doc["config"]["backend"] != "serial":
        raise AssertionError(f"plan_cli: no build-index for {doc['config']}")
    ready = os.path.join(tmp, "serve.url")
    t0 = time.perf_counter()
    proc = subprocess.Popen(shlex.split(cmds["serve"])
                            + ["--port", "0", "--ready-file", ready, "-q"],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        hz = None
        while time.perf_counter() - t0 < PLAN_BOOT_S:
            if proc.poll() is not None:
                raise AssertionError(f"plan_cli: serve exited {proc.returncode}: "
                                     f"{proc.stderr.read()[-2000:]}")
            if os.path.exists(ready) and open(ready).read().strip():
                url = open(ready).read().strip()
                hz = json.loads(urllib.request.urlopen(url + "/healthz",
                                                       timeout=10).read())
                if hz["ready"]:
                    break
            time.sleep(0.2)
        boot_s = time.perf_counter() - t0
        if not (hz and hz["ready"]):
            raise AssertionError(f"plan_cli: serve not ready in {PLAN_BOOT_S} s")
        q = json.dumps({"queries": queries.tolist()}).encode()
        req = urllib.request.Request(url + "/query", data=q, headers={
            "Content-Type": "application/json"})
        answer = json.loads(urllib.request.urlopen(req, timeout=60).read())
        hz = json.loads(urllib.request.urlopen(url + "/healthz", timeout=10).read())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    got = np.asarray(answer["ids"])
    rec = tie_recall(got, od, oi) if got.shape == (len(queries), K) else -1.0
    prof = hz["device_profile"] or {}
    out = {"phase": "plan_cli", "argv": " ".join(argv), "rc": rc,
           "profile": doc["fleet"]["profile"], "config": doc["config"],
           "predicted": {k: pred[k] for k in (
               "recall_at_k", "bucket_cap", "resident_bytes", "peak_hbm_bytes",
               "qps", "roofline_bound", "wire_bytes_per_batch")},
           "commands": cmds, "build_index_s": build_s,
           "built_bucket_cap": cap, "serve_ready_s": boot_s,
           "healthz": {"device_profile": prof.get("name"),
                       "peak_hbm_bytes": hz["peak_hbm_bytes"],
                       "backend": hz["backend"]},
           "answered_rows": len(answer["ids"]), "recall_at_10": rec,
           "serve_rc": proc.returncode}
    emit(out)
    if not ((cap is None or cap <= pred["bucket_cap"])
            and prof.get("name") == PLAN_PROFILE
            and 0 < hz["peak_hbm_bytes"] <= pred["peak_hbm_bytes"]
            and rec >= pred["recall_at_k"] - PLAN_RECALL_SLACK):
        raise AssertionError(f"plan_cli: {out}")
    return out


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
    path (no Pallas site lies on the JAX package's).

    The planner against the card (``ivf_plan``, ``plan_cli``): the
    allocator's peak is reset before each store's build, and its growth
    over the build, the one-shot search and serving is held at or under
    the planner's predicted peak for that store (a bfloat16 store is built
    and searched once for its peak alone); on every served store the
    predicted bucket_cap is at least the built one and the served q/s at
    most the roofline's, and its recall at least the predicted recall -
    PLAN_RECALL_SLACK. Then ``plan`` for the
    README deployment, and the same restricted to ``--backend ivf``, each
    with its emitted commands run as emitted (``plan_cli``)."""
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
    profile = plan_profile(device)
    reset_counts()
    results = {}
    for dtype, bar, nq in IVF_STORES:
        if nq < IVF_QUERIES:
            emit({"phase": "ivf_cut", "store": dtype, "queries": nq,
                  "of": IVF_QUERIES})
        Qn = Q[:nq]
        # the planner's check: the allocator's growth from here
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        mem_base = torch.cuda.memory_allocated(device)
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
        torch.cuda.synchronize()
        ivf_plan_check(index, dtype,
                       torch.cuda.max_memory_allocated(device) - mem_base, nq,
                       served, rec)

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

    ivf_peak_bfloat16(X, Q, device)

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
    del full
    torch.cuda.empty_cache()
    # the plan for the README deployment, and with --backend ivf, each
    # deployed by its own commands: the two deployments' children (a
    # serve, a build-index and a serve) run side by side on the card
    def deploy(restrict):
        with tempfile.TemporaryDirectory() as tmp:
            return plan_cli(tmp, restrict, Q[sample], od, oi)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(deploy, r) for r in ((), ("--backend", "ivf"))]:
            f.result()
    counts = {name: n for name, n in read_counts().items() if n}
    emit({"phase": "ivf_launches", "launches": counts,
          "seconds": time.perf_counter() - t_phase, "stores": results,
          "copy_bytes_per_s": profile["copy_bytes_per_s"]})
    if counts:
        raise AssertionError(f"ivf: kernels launched on the IVF path: {counts}")
    return results


# ---- live mutation: the README's mutable deployment (README.md:649-667) ----
MUT_STORES = ("float32", "int8")
MUT_BUCKET = 128  # mutation_bucket, and the upsert / delete chunk
MUT_ID_BASE = 1_000_000  # new ids, as the README's --ids 1000000:1000128
MUT_CYCLES = 16  # timed upsert + delete cycles (median)
MUT_CHURN = IVF_M // 10  # rows upserted as new ids, and rows deleted
MUT_WINDOWS = 3  # passes of the held-out queries a serving window takes
MUT_SELF_ROWS = 512  # upserted rows queried for themselves
MUT_OFFSET = 0.5  # the self query's offset a coordinate: d^2 = 32, past the zero rule


def mutation_pool():
    """Rows of the corpus's distribution that are neither corpus rows nor the
    ``ivf`` phase's held-out queries: the tail of a longer second chunk of
    ``make_sift_like`` (the same 256 centers, other draws)."""
    from mpi_knn_tpu_torch.data.synthetic import make_sift_like

    return make_sift_like(IVF_M + 4 * MUT_CHURN, seed=0, chunk=IVF_M)[IVF_M + 2 * MUT_CHURN:]


def mut_store(index):
    from mpi_knn_tpu_torch.serve import mutate as sm

    return [t for t in sm._store(index) if t is not None]


def mut_clone(index):
    """A copy of a clustered index on its device: the same bits, no shared
    storage, its freelist derived anew."""
    import dataclasses

    return dataclasses.replace(
        index, centroids=index.centroids.clone(), centroid_sqs=index.centroid_sqs.clone(),
        buckets=index.buckets.clone(), bucket_ids=index.bucket_ids.clone(),
        bucket_sqs=index.bucket_sqs.clone(),
        bucket_scales=None if index.bucket_scales is None else index.bucket_scales.clone(),
        _cache={})


def mut_serve(sess, batches, churn=None) -> dict:
    """One window of ``batches`` through the session, optionally beside a
    churning thread (``churn(stop, note)``, which calls ``note(ids)`` after
    each delete returns). Every batch must be finite and return no id deleted
    before it was submitted. Returns p50 / p99 ms and q/s."""
    import threading

    deleted, lock, stop = set(), threading.Lock(), threading.Event()

    def note(ids):
        with lock:
            deleted.update(int(i) for i in ids)

    worker = None
    if churn is not None:
        worker = threading.Thread(target=churn, args=(stop, note))
        worker.start()
    sess.reset_stats()
    gone_at, done = [], []
    t0 = time.perf_counter()
    try:
        for b in batches:
            with lock:
                gone_at.append(frozenset(deleted))
            done += sess.submit(b)
        done += sess.drain()
    finally:
        stop.set()
        if worker is not None:
            worker.join(timeout=120)
    wall = time.perf_counter() - t0
    if worker is not None and worker.is_alive():
        raise AssertionError("mutate: the churning thread did not stop")
    base = done[0].seq
    bad = [r.seq for r in done
           if not np.isfinite(r.dists).all()
           or gone_at[r.seq - base] & set(r.ids.ravel().tolist())]
    if bad:
        raise AssertionError(f"mutate: batches {bad[:5]} non-finite or returned "
                             "a deleted id")
    lat = 1e3 * np.asarray(sess.latencies)
    return {"batches": len(done), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "qps": sum(r.rows for r in done) / wall, "deleted_during": len(deleted)}


def mutate_phase(device) -> dict:
    """Live mutation at the README's mutable deployment: the ``ivf`` phase's
    corpus (``sift:100000``, 256 partitions) built with ``bucket_headroom=
    0.5`` and ``mutation_bucket=128``, float32 and int8 stores, 128-row
    chunks under new ids from 1000000, 512-row query batches (bucket base
    1024, depth 2) of the ``ivf`` phase's held-out queries. Gates: every
    live row upserted again under its own id keeps the store bit for bit;
    every store tensor keeps its storage and an upsert + delete's peak
    allocation grows by a few chunk sizes only; rows/s of upserts and
    deletes (median of MUT_CYCLES cycles); serving quiesced and beside a
    churning thread (p50 / p99, every batch finite, no id deleted before
    its submission returned); after churn of 10 % new rows and 10 %
    deletes, each upserted row its own first neighbour, no deleted id
    returned, recall@10 against an f64 oracle over the live rows at least
    a fresh build's on the same rows minus 0.02; compaction with retraining
    twice from one state gives the same bits; after compaction nprobe =
    partitions equals serial over the live rows (float32); the rebuild per
    batch beside an upsert (the reference's bar: >= 10x); every kernel
    launch count stays 0 (no kernel lies on this path)."""
    import threading

    import torch

    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf
    from mpi_knn_tpu_torch.serve import ServeSession
    from mpi_knn_tpu_torch.serve import mutate as sm

    t_phase = time.perf_counter()
    X, Q = ivf_data()
    pool = mutation_pool()
    sample = np.linspace(0, IVF_QUERIES - 1, IVF_ORACLE_ROWS).astype(np.int64)
    batches = [Q[s:s + IVF_BATCH] for s in range(0, IVF_QUERIES, IVF_BATCH)]
    rng = np.random.default_rng(14)
    gone = np.sort(rng.choice(IVF_M, MUT_CHURN, replace=False))
    reset_counts()
    results = {}
    for dtype in MUT_STORES:
        cfg = KNNConfig(k=K, partitions=IVF_P, dtype=dtype, bucket_headroom=0.5,
                        mutation_bucket=MUT_BUCKET)
        t0 = time.perf_counter()
        index = build_ivf_index(X, cfg, device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        store_bytes = sum(t.numel() * t.element_size() for t in mut_store(index))

        # every live row again, its own id and raw values, 128 rows a chunk
        before = [t.clone() for t in mut_store(index)]
        ptrs = [t.data_ptr() for t in mut_store(index)]
        t0 = time.perf_counter()
        for s in range(0, IVF_M, MUT_BUCKET):
            sm.upsert_rows(index, np.arange(s, min(s + MUT_BUCKET, IVF_M)),
                           X[s:s + MUT_BUCKET])
        torch.cuda.synchronize()
        reupsert_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(mut_store(index), before))
        del before

        # rows/s, and the peak allocation of one upsert + delete cycle
        next_id = [MUT_ID_BASE]

        def cycle():
            ids = np.arange(next_id[0], next_id[0] + MUT_BUCKET)
            rows = pool[(next_id[0] - MUT_ID_BASE) % (len(pool) - MUT_BUCKET):][:MUT_BUCKET]
            next_id[0] += MUT_BUCKET
            t0 = time.perf_counter()
            sm.upsert_rows(index, ids, rows)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sm.delete_rows(index, ids)
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1

        cycle()  # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        cycle()
        grew = torch.cuda.max_memory_allocated(device) - base
        chunk_bytes = MUT_BUCKET * (X.shape[1] + IVF_P) * 4
        times = [cycle() for _ in range(MUT_CYCLES)]
        up_s = statistics.median(t[0] for t in times)
        del_s = statistics.median(t[1] for t in times)
        in_place = [t.data_ptr() for t in mut_store(index)] == ptrs
        emit({"phase": "mutate_in_place", "store": dtype, "m": IVF_M,
              "partitions": IVF_P, "bucket_cap": index.bucket_cap,
              "build_s": build_s, "store_bytes": store_bytes,
              "reupsert_rows": IVF_M, "reupsert_s": reupsert_s,
              "reupsert_bit_for_bit": same, "data_ptr_unchanged": in_place,
              "peak_growth_bytes": grew, "chunk_bytes": chunk_bytes,
              "peak_bound_bytes": 8 * chunk_bytes,
              "upsert_ms_median": 1e3 * up_s, "delete_ms_median": 1e3 * del_s,
              "upsert_rows_per_s": MUT_BUCKET / up_s,
              "delete_rows_per_s": MUT_BUCKET / del_s,
              "cycles": MUT_CYCLES, "chunk_rows": MUT_BUCKET,
              "upsert_ms_runs": [1e3 * t[0] for t in times],
              "delete_ms_runs": [1e3 * t[1] for t in times]})
        if not (same and in_place and grew <= 8 * chunk_bytes):
            raise AssertionError(f"mutate {dtype}: the re-upsert changed the store "
                                 f"({same}), a tensor moved ({in_place}), or the "
                                 f"peak grew {grew} > 8 x {chunk_bytes} bytes")

        # serving, quiesced and beside a churning thread
        sess = ServeSession(index, device=device)
        sess.warm([IVF_BATCH])
        window = batches * MUT_WINDOWS
        quiet = mut_serve(sess, window)

        def churn(stop, note):
            while not stop.is_set():
                ids = np.arange(next_id[0], next_id[0] + MUT_BUCKET)
                rows = pool[(next_id[0] - MUT_ID_BASE) % (len(pool) - MUT_BUCKET):][:MUT_BUCKET]
                next_id[0] += MUT_BUCKET
                sess.upsert(ids, rows)
                sess.delete(ids)
                note(ids)

        busy = mut_serve(sess, window, churn)
        emit({"phase": "mutate_serve", "store": dtype, "batch": IVF_BATCH,
              "bucket": sess.cfg.query_bucket, "depth": sess.cfg.dispatch_depth,
              "quiesced": quiet, "under_churn": busy,
              "p99_ratio": busy["p99_ms"] / quiet["p99_ms"],
              "p50_ratio": busy["p50_ms"] / quiet["p50_ms"],
              "mutation": sess.stats_snapshot()["mutation"]})

        # churn: 10 % new rows under new ids, 10 % of the corpus deleted
        new_rows = pool[:MUT_CHURN]
        new_ids = np.arange(2 * MUT_ID_BASE, 2 * MUT_ID_BASE + MUT_CHURN)
        for s in range(0, MUT_CHURN, MUT_BUCKET):
            sess.upsert(new_ids[s:s + MUT_BUCKET], new_rows[s:s + MUT_BUCKET])
            sess.delete(gone[s:s + MUT_BUCKET])
        churned = sm.mutation_stats(index)
        own = np.linspace(0, MUT_CHURN - 1, MUT_SELF_ROWS).astype(np.int64)
        _, si = search_ivf(index, new_rows[own] + MUT_OFFSET, device=device)
        self_first = float((si[:, 0].cpu().numpy() == new_ids[own]).mean())
        _, gi = search_ivf(index, np.concatenate([Q, X[gone[:MUT_SELF_ROWS]] + MUT_OFFSET]),
                           device=device)
        returned_deleted = int(np.isin(gi.cpu().numpy(), gone).sum())
        live_ids = np.concatenate([np.setdiff1d(np.arange(IVF_M), gone), new_ids])
        live_rows = np.concatenate([X[np.setdiff1d(np.arange(IVF_M), gone)], new_rows])
        od, oi = ivf_oracle(live_rows, Q[sample], device)
        oi = live_ids[oi]
        t0 = time.perf_counter()
        fresh = build_ivf_index(live_rows, cfg, device=device)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        _, mi = search_ivf(index, Q[sample], device=device)
        _, fi = search_ivf(fresh, Q[sample], device=device, nprobe=index.nprobe)
        rec_mut = tie_recall(mi.cpu().numpy(), od, oi)
        rec_fresh = tie_recall(live_ids[fi.cpu().numpy()], od, oi)
        del fresh
        emit({"phase": "mutate_churn", "store": dtype, "upserted": MUT_CHURN,
              "deleted": MUT_CHURN, "freelist": churned, "nprobe": index.nprobe,
              "self_first_neighbour": self_first, "deleted_returned": returned_deleted,
              "recall_at_10": rec_mut, "recall_fresh_build": rec_fresh,
              "rebuild_s": rebuild_s, "rebuild_rows": len(live_rows),
              "upsert_s_per_chunk": up_s, "rebuild_per_batch_ratio": rebuild_s / up_s})
        if self_first < 1.0 or returned_deleted or rec_mut < rec_fresh - 0.02:
            raise AssertionError(f"mutate {dtype}: self first {self_first}, deleted "
                                 f"returned {returned_deleted}, recall {rec_mut} "
                                 f"against a fresh build's {rec_fresh}")
        if rebuild_s < 10 * up_s:
            raise AssertionError(f"mutate {dtype}: a rebuild ({rebuild_s} s) is not "
                                 f"10x an upsert chunk ({up_s} s)")

        # compaction: retrained twice from one state, the same bits; then
        # without retraining
        twin = mut_clone(index)
        t0 = time.perf_counter()
        st = sm.compact_index(index, retrain=True, reason="smoke")
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        sm.compact_index(twin, retrain=True, reason="smoke")
        twice = all(torch.equal(a, b) for a, b in zip(mut_store(index) + [index.centroids],
                                                       mut_store(twin) + [twin.centroids]))
        del twin
        t0 = time.perf_counter()
        st2 = sm.compact_index(index, retrain=False, reason="smoke")
        torch.cuda.synchronize()
        compact_plain_s = time.perf_counter() - t0
        _, ci = search_ivf(index, Q[sample], device=device)
        rec_compacted = tie_recall(ci.cpu().numpy(), od, oi)
        full = {}
        if dtype == "float32":
            # nprobe = partitions is a full scan: serial over the live rows
            gd, gi = search_ivf(index, Q[sample], device=device, nprobe=IVF_P)
            want = all_knn(live_rows, queries=Q[sample],
                           config=KNNConfig(k=K, backend="serial"), device=device)
            wd, wi = want.dists.cpu().numpy(), live_ids[want.ids.cpu().numpy()]
            full = {"ids_agree": tie_recall(gi.cpu().numpy(), wd, wi),
                    "within_1e-5": bool(np.allclose(gd.cpu().numpy(), wd,
                                                    rtol=1e-5, atol=1e-5))}
        emit({"phase": "mutate_compact", "store": dtype, "retrained": st,
              "plain": st2, "compact_s": compact_s, "compact_no_retrain_s": compact_plain_s,
              "retrain_twice_equal": twice, "recall_at_10": rec_compacted,
              "freelist": sm.mutation_stats(index), "full_scan": full})
        if not twice or (full and (full["ids_agree"] < 0.999 or not full["within_1e-5"])):
            raise AssertionError(f"mutate {dtype}: compaction twice differs ({twice}) "
                                 f"or the full scan disagrees with serial ({full})")
        results[dtype] = {"upsert_rows_per_s": MUT_BUCKET / up_s,
                          "delete_rows_per_s": MUT_BUCKET / del_s,
                          "p99_ratio": busy["p99_ms"] / quiet["p99_ms"],
                          "compact_s": compact_s, "rebuild_ratio": rebuild_s / up_s}
        del index, sess
        torch.cuda.empty_cache()
    counts = {name: n for name, n in read_counts().items() if n}
    emit({"phase": "mutate_launches", "launches": counts,
          "seconds": time.perf_counter() - t_phase, "stores": results})
    if counts:
        raise AssertionError(f"mutate: kernels launched on the mutation path: {counts}")
    return results


OPS_BATCH = 256  # the serve phase's stream (a): 256-row batches, bucket base 1024
OPS_WINDOWS = 3  # alternated timed windows of each overhead config
OPS_DEADLINE_S = 0.1  # the ladder walks' per-batch deadline
OPS_SLOW_S = 0.15  # an injected slow dispatch: 0.15 s > the deadline
OPS_WALK = 8  # slow batches of the pallas walk (the IVF walk takes 2 more)
OPS_RESTART_BATCHES = 4  # batches a restarted child serves
OPS_TRUNCATED = "approx_topk"  # the library whose entry the third child finds cut
# the libraries a restarted child loads before it serves: the served pallas
# index's (K1, K1[c] and their prologues) and the one the third child finds
# cut; the ring's libraries, which it never loads, stay out of its nvcc time
OPS_LIBRARIES = ("fused_knn", OPS_TRUNCATED)

# A restarted process: the cache at argv[1], the corpus and queries saved
# at argv[2]; loads every kernel library (through the cache), builds the
# pallas index, serves the first batches, prints one JSON line.
OPS_CHILD = r"""
import time
t_start = time.perf_counter()
import hashlib, json, sys
import numpy as np
import torch
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch.obs.metrics import get_registry
from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.serve import ServeSession, aotcache, build_index

cache_dir, data_dir, device, k, bucket, batch, nb, libs = sys.argv[1:9]
aotcache.set_cache_dir(cache_dir)
dev = torch.device(device)
torch.zeros(1, device=dev)
t_device = time.perf_counter()
if dev.type == "cuda":
    _build.load_all([(name, ()) for name in libs.split(",")])
t_libs = time.perf_counter()
X = np.load(data_dir + "/X.npy")
Q = np.load(data_dir + "/Q.npy")
index = build_index(X, KNNConfig(k=int(k), backend="pallas",
                                 query_bucket=int(bucket), dispatch_depth=2),
                    device=dev)
ses = ServeSession(index, device=dev)
b = int(batch)
first, digest = None, hashlib.sha256()
for res in ses.stream([Q[i * b:(i + 1) * b] for i in range(int(nb))]):
    first = first or time.perf_counter()
    digest.update(res.ids.tobytes())
    digest.update(res.dists.tobytes())
reg = get_registry()
print(json.dumps({
    **{n: reg.counter(n).value for n in (
        "nvcc_builds_total", "aot_cache_hits_total", "aot_cache_misses_total",
        "aot_cache_errors_total", "aot_cache_stores_total")},
    "seconds_to_device": t_device - t_start,
    "seconds_to_libraries": t_libs - t_start,
    "seconds_to_first_answer": first - t_start,
    "digest": digest.hexdigest()}))
"""

# The doctor's supervisor in a process of its own: its verdict line, then
# whether that process ever loaded torch or initialized CUDA.
OPS_DOCTOR = r"""
import json, sys
from mpi_knn_tpu_torch.resilience.doctor import main
rc = main(sys.argv[1:])
loaded = "torch" in sys.modules
import torch
print(json.dumps({"rc": rc, "torch_loaded": loaded,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def ops_start(script, *args, env=None):
    """Start a child of this checkout (its package importable from here)."""
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def ops_wait(proc, name, timeout=600) -> list:
    """The child's JSON stdout lines, after it exits 0 (else raises, with
    the tail of its stderr)."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"ops {name}: exit {proc.returncode}:\n{err[-3000:]}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def ops_digest(results) -> str:
    import hashlib

    h = hashlib.sha256()
    for r in results:
        h.update(r.ids.tobytes())
        h.update(r.dists.tobytes())
    return h.hexdigest()


def ops_window(session, batches) -> dict:
    """One timed window of ``batches`` through ``session``: its results,
    q/s, p50 / p99 and the median host ms of ``submit``."""
    session.reset_stats()
    t0 = time.perf_counter()
    results = list(session.stream(batches))
    wall = time.perf_counter() - t0
    lats = 1e3 * np.asarray(session.latencies)
    return {"results": results, "qps": session.queries_served / wall,
            "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99)),
            "host_ms": statistics.median(r.host_ms for r in results)}


def ops_walk(session, batch, n):
    """``n`` batches under an injected slow dispatch, drained: each batch's
    (seq, rung it was dispatched under, breached), and the results."""
    from mpi_knn_tpu_torch.resilience import install_faults
    from mpi_knn_tpu_torch.resilience.ladder import FULL_RUNG

    results = []
    with install_faults({"serve-batch": ("slow", OPS_SLOW_S)}):
        for _ in range(n):
            results += session.submit(batch)
        results += session.drain()
    return [(r.seq, r.degraded or FULL_RUNG, r.deadline_breached)
            for r in results], results


def ops_oracle(c, q, device):
    """f64 on the card: each of q's K + 5 nearest rows of c, the zero rule
    d <= 1e-6 (q^2 + c^2) as the kernels apply it, ties to the lower id.
    Host (dists, ids)."""
    import torch

    c64 = torch.from_numpy(c).to(device, torch.float64)
    q64 = torch.from_numpy(q).to(device, torch.float64)
    q_sq, c_sq = (q64 * q64).sum(1)[:, None], (c64 * c64).sum(1)[None]
    d = (q_sq + c_sq - 2.0 * q64 @ c64.T).clamp_min(0.0)
    d[d <= 1e-6 * (q_sq + c_sq)] = float("inf")
    vals, ids = torch.sort(d, dim=1, stable=True)
    return vals[:, :K + 5].cpu().numpy(), ids[:, :K + 5].cpu().numpy()


def ops_same(results, want) -> bool:
    return all(np.array_equal(r.ids, w.ids) and np.array_equal(r.dists, w.dists)
               for r, w in zip(results, want)) and len(results) == len(want)


def ops_phase(device, X, inputs, keep_cache=None) -> None:
    """The serving session's operations layer at the serve phase's
    deployment (the 60000x784 pallas tiles exact index, 256-row batches of
    its 10000 queries, bucket base 1024, depth 2) and the ``ivf`` phase's
    (``sift:100000``, 256 partitions, nprobe 2):

    - faults, on one session under a policy (deadline OPS_DEADLINE_S,
      retries 2, degrade after 2): ``serve-batch=transient:2`` serves in 3
      attempts with backoffs (0.05, 0.1), bit for bit; ``transient:3``
      raises RetryExhausted; ``serve-nan=nan`` trips the sentinel with the
      batch's seq, bucket and rung;
    - the ladder walks under ``serve-batch=slow:OPS_SLOW_S``: pallas full
      -> mixed -> bucket/512 (the mixed rung's bf16 copy staged when the
      session is made, its bytes printed), IVF full -> nprobe/1 -> mixed
      -> bucket/512; every walked batch bit for bit a session built at its
      rung; nothing built after warm; K1 and K1[c] launched on the walk
      (the counts set to 0 just before); how many batches pass between the
      first slow batch and the first one at the shed rung;
    - the registry's counters equal that session's own (batches, queries,
      retries, breaches, degradations, poisoned), and its snapshot
      round-trips the Prometheus text;
    - the cache: three children with one cache directory, each loading
      OPS_LIBRARIES before it serves: cold (each built by nvcc and
      stored), warm (no build, one hit a library) and, on a copy, with
      the OPS_TRUNCATED entry cut in half
      (one error, that library rebuilt); their results bit for bit; the
      seconds to the first answer;
    - the doctor on the card, while the cold child builds (ok, K1's launch
      counted, a round trip through a cache of its own, a mutation probe
      whose second pass builds nothing; its supervisor never loads torch
      nor initializes CUDA), and with ``doctor-probe=hang``, ``--timeout
      5`` (exit 1, ``timeout``, within the timeout and the kill's grace);
    - timed windows, alternated: the stream with and without a policy
      (deadline 1 s, retries 2, sentinel on) and with a flight record,
      every batch bit for bit the session without a policy; each rung's
      q/s, p99 and tie-aware recall@10 against an f64 oracle with the
      kernels' zero rule (pallas: full 1.0, mixed >= RECALL_GATE,
      bucket/512 bit for bit mixed; IVF: full >= 0.95, nprobe/1 beside its
      recall_target);
    - the flight records pass validate_flight, the exhausted and poisoned
      batches' spans closed with their errors."""
    import shutil

    from mpi_knn_tpu_torch import KNNConfig, ServeSession, build_index
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.obs import metrics as obs_metrics
    from mpi_knn_tpu_torch.obs import spans as obs_spans
    from mpi_knn_tpu_torch.ops import _build
    from mpi_knn_tpu_torch.resilience import (
        PoisonedResultError,
        ResiliencePolicy,
        RetryExhausted,
        install_faults,
    )
    from mpi_knn_tpu_torch.resilience.ladder import FULL_RUNG
    from mpi_knn_tpu_torch.serve import aotcache

    t_phase = time.perf_counter()
    card = device.type == "cuda"
    platform = "cuda" if card else "cpu"
    reg = obs_metrics.get_registry()
    tmp = tempfile.mkdtemp(prefix="tknn-ops-")
    children = []
    try:
        # ---- a cold child first: its nvcc builds overlap what follows ----
        Qs = inputs["Qs"]
        np.save(os.path.join(tmp, "X.npy"), X)
        np.save(os.path.join(tmp, "Q.npy"), Qs[:OPS_RESTART_BATCHES * OPS_BATCH])
        cache_a, cache_b = os.path.join(tmp, "cache_a"), os.path.join(tmp, "cache_b")
        child_args = (tmp, platform, K, SERVE_BUCKET, OPS_BATCH, OPS_RESTART_BATCHES,
                      ",".join(OPS_LIBRARIES))
        t_cold = time.perf_counter()
        cold = ops_start(OPS_CHILD, cache_a, *child_args)
        children.append(cold)

        # ---- faults, on one session under a policy -------------------------
        flight = os.path.join(tmp, "flight.jsonl")
        obs_spans.set_recorder(obs_spans.FlightRecorder(flight, fresh=True))
        index = build_index(X, KNNConfig(k=K, backend="pallas",
                                         query_bucket=SERVE_BUCKET,
                                         dispatch_depth=2), device=device)
        plain = ServeSession(index, device=device)
        fault = ServeSession(index, resilience=ResiliencePolicy(
            batch_deadline_s=OPS_DEADLINE_S, max_retries=2, degrade_after=2),
            device=device)
        labels = [lb for lb, _ in fault.ladder]
        emit({"phase": "ops_ladder", "index": "pallas/tiles/exact", "ladder": labels,
              "staged_bytes": fault.staged_bytes,
              "nbytes_resident": index.nbytes_resident})
        floor = f"bucket/{SERVE_BUCKET // 2}"
        if labels != [FULL_RUNG, "mixed", floor]:
            raise AssertionError(f"ops: the pallas ladder is {labels}")
        if card and not fault.staged_bytes:
            raise AssertionError("ops: the mixed rung's corpus part was not staged")
        batch = Qs[:OPS_BATCH]
        plain.warm([OPS_BATCH])
        fault.warm([OPS_BATCH])
        want0 = list(plain.stream([batch]))
        rungs = {lb: ServeSession(index, cfg, device=device) for lb, cfg in fault.ladder}
        for s in rungs.values():
            s.warm([OPS_BATCH])
        rung_want = {lb: list(s.stream([batch])) for lb, s in rungs.items()}
        # from here to ops_metrics only the fault session serves
        before = {n: reg.counter(n).value for n in (
            "serve_batches_total", "serve_queries_total", "serve_retries_total",
            "serve_deadline_breaches_total", "serve_degradations_total",
            "serve_poisoned_results_total")}
        with install_faults({"serve-batch": ("transient", 2)}):
            got = fault.submit(batch) + fault.drain()
        same = ops_same(got, want0)
        emit({"phase": "ops_transient", "attempts": got[0].attempts,
              "backoffs": list(got[0].backoffs), "bit_for_bit": same})
        if (got[0].attempts, got[0].backoffs, same) != (3, (0.05, 0.1), True):
            raise AssertionError(f"ops: transient:2 gave {got[0].attempts} attempts,"
                                 f" backoffs {got[0].backoffs}, bit for bit {same}")
        exhausted = None
        with install_faults({"serve-batch": ("transient", 3)}):
            try:
                fault.submit(batch)
            except RetryExhausted as e:
                exhausted = e.attempts
        nan_seq, poisoned = fault._seq, None
        with install_faults({"serve-nan": "nan"}):
            fault.submit(batch)
        try:
            fault.drain()
        except PoisonedResultError as e:
            poisoned = [e.batch_seq, e.bucket, e.rung]
        emit({"phase": "ops_faults", "exhausted_attempts": exhausted,
              "poisoned": poisoned})
        if exhausted != 3 or poisoned != [nan_seq, SERVE_BUCKET, FULL_RUNG]:
            raise AssertionError(f"ops: exhausted after {exhausted} attempts, "
                                 f"poisoned {poisoned} (seq {nan_seq})")

        # ---- the ladder walks -----------------------------------------------
        reset_counts()
        with obs_metrics.watch_compiles() as builds:
            walk, walked = ops_walk(fault, batch, OPS_WALK)
        counts = {k: v for k, v in read_counts().items() if v}
        same = all(ops_same([r], rung_want[lb]) for (_, lb, _), r in zip(walk, walked))
        first_shed = next(i for i, (_, lb, _) in enumerate(walk) if lb != FULL_RUNG)
        emit({"phase": "ops_walk", "index": "pallas/tiles/exact",
              "deadline_s": OPS_DEADLINE_S, "slow_s": OPS_SLOW_S, "degrade_after": 2,
              "walk": walk, "degradations": fault.degradations,
              "batches_before_the_first_at_a_shed_rung": first_shed,
              "builds_after_warm": builds, "launches": counts,
              "bit_for_bit_rung_sessions": same})
        if walk[-1][1] != floor or builds or not same:
            raise AssertionError(f"ops: pallas walk {walk}, builds {builds}, "
                                 f"bit for bit {same}")
        if card and not (counts.get("fused_knn_tiles")
                         and counts.get("fused_knn_tiles[compress]")):
            raise AssertionError(f"ops: the walk launched {counts}")
        deltas = {n: reg.counter(n).value - v for n, v in before.items()}
        own = {"serve_batches_total": len(fault.latencies) - 1,  # not the poisoned
               "serve_queries_total": fault.queries_served - OPS_BATCH,
               "serve_retries_total": fault.retries_total,
               "serve_deadline_breaches_total": fault.deadline_breaches,
               "serve_degradations_total": len(fault.degradations),
               "serve_poisoned_results_total": 1}
        snap = reg.snapshot()
        samples = obs_metrics.parse_prometheus(obs_metrics.to_prometheus(snap))
        emit({"phase": "ops_metrics", "registry_deltas": deltas, "session": own,
              "metrics": len(snap["metrics"]), "prometheus_samples": len(samples)})
        if deltas != own:
            raise AssertionError(f"ops: registry {deltas} != session {own}")

        Xs, Qv = ivf_data()
        ivf = build_ivf_index(Xs, KNNConfig(k=K, partitions=IVF_P), device=device)
        ivf_batch = Qv[:IVF_BATCH]
        ifault = ServeSession(ivf, resilience=ResiliencePolicy(
            batch_deadline_s=OPS_DEADLINE_S, max_retries=0, degrade_after=2),
            device=device)
        ilabels = [lb for lb, _ in ifault.ladder]
        irungs = {lb: ServeSession(ivf, cfg, device=device) for lb, cfg in ifault.ladder}
        for s in (ifault, *irungs.values()):
            s.warm([IVF_BATCH])
        iwant = {lb: list(s.stream([ivf_batch])) for lb, s in irungs.items()}
        with obs_metrics.watch_compiles() as ibuilds:
            iwalk, iwalked = ops_walk(ifault, ivf_batch, OPS_WALK + 2)
        isame = all(ops_same([r], iwant[lb]) for (_, lb, _), r in zip(iwalk, iwalked))
        emit({"phase": "ops_walk", "index": "ivf/sift:100000/p256",
              "nprobe": ivf.cfg.nprobe, "ladder": ilabels, "walk": iwalk,
              "degradations": ifault.degradations, "builds_after_warm": ibuilds,
              "bit_for_bit_rung_sessions": isame})
        # the reference's rule: nprobe halved, then mixed, then the bucket
        ifloor = f"bucket/{ivf.cfg.query_bucket // 2}"
        iwant_labels = [FULL_RUNG, *([f"nprobe/{ivf.cfg.nprobe // 2}"]
                                     if ivf.cfg.nprobe > 1 else []), "mixed", ifloor]
        if ilabels != iwant_labels or ibuilds or not isame or iwalk[-1][1] != ifloor:
            raise AssertionError(f"ops: ivf walk {iwalk} of {ilabels}, builds "
                                 f"{ibuilds}, bit for bit {isame}")
        obs_spans.set_recorder(None)
        records = obs_spans.read_flight(flight)
        problems = obs_spans.validate_flight(records)
        spans, _ = obs_spans.reconstruct_spans(records)
        errors = sorted(str(s["end_attrs"].get("error")) for s in spans
                        if s["name"] == "batch" and s["end_attrs"]
                        and s["end_attrs"].get("error"))
        open_spans = [s["name"] for s in spans if s["dur_s"] is None]
        emit({"phase": "ops_flight", "records": len(records), "spans": len(spans),
              "problems": problems, "batch_errors": errors, "open": open_spans})
        if problems or open_spans or errors != ["RetryExhausted", "poisoned-result"]:
            raise AssertionError(f"ops: flight {problems}, open {open_spans}, "
                                 f"errors {errors}")

        # ---- the doctor (a cache of its own) while the cold child builds ------
        env = {k: v for k, v in os.environ.items() if k != "TKNN_FAULTS"}
        doctor = ops_start(OPS_DOCTOR, "--platform", platform, "--cache-dir",
                           os.path.join(tmp, "cache_c"), env=env)
        t_hang = time.perf_counter()
        hang = ops_start(OPS_DOCTOR, "--platform", platform, "--timeout", "5",
                         env={**env, "TKNN_FAULTS": "doctor-probe=hang"})
        children += [doctor, hang]
        hang_verdict, hang_proc = ops_wait(hang, "doctor (hang)")
        hang_s = time.perf_counter() - t_hang
        verdict, doctor_proc = ops_wait(doctor, "doctor")

        # ---- the restarted children -------------------------------------------
        (cold_doc,) = ops_wait(cold, "cold child")
        cold_s = time.perf_counter() - t_cold
        shutil.copytree(cache_a, cache_b)
        cut = os.path.join(cache_b, aotcache.fingerprint(
            OPS_TRUNCATED, (), aotcache.platform_facts()) + aotcache.ENTRY_SUFFIX)
        if card:  # off the card no library was built
            with open(cut, "r+b") as f:
                f.truncate(os.path.getsize(cut) // 2)
        warm = ops_start(OPS_CHILD, cache_a, *child_args)
        t_damaged = time.perf_counter()
        damaged = ops_start(OPS_CHILD, cache_b, *child_args)
        children += [warm, damaged]
        (warm_doc,) = ops_wait(warm, "warm child")
        here = ops_digest(list(plain.stream(
            [Qs[i * OPS_BATCH:(i + 1) * OPS_BATCH] for i in range(OPS_RESTART_BATCHES)])))
        n_libs = len(OPS_LIBRARIES)
        emit({"phase": "ops_cache", "cold": cold_doc, "warm": warm_doc,
              "cold_child_wall_s": cold_s, "libraries": n_libs,
              "equals_this_process": cold_doc["digest"] == here})
        if card and (cold_doc["nvcc_builds_total"], cold_doc["aot_cache_misses_total"],
                     cold_doc["aot_cache_stores_total"]) != (n_libs,) * 3:
            raise AssertionError(f"ops: the cold child {cold_doc}")
        if card and (warm_doc["nvcc_builds_total"], warm_doc["aot_cache_hits_total"],
                     warm_doc["aot_cache_misses_total"]) != (0, n_libs, 0):
            raise AssertionError(f"ops: the warm child {warm_doc}")
        if not warm_doc["digest"] == cold_doc["digest"] == here:
            raise AssertionError("ops: the children's results differ from each "
                                 "other or from this process's")
        probe = verdict.get("probe") or {}
        plan_line = verdict.get("plan") or {}
        emit({"phase": "ops_doctor", "ok": verdict["ok"], "status": verdict["status"],
              "probe": probe, "aot_cache": verdict["aot_cache"],
              "plan": plan_line,
              "mutation": verdict["mutation"], "elapsed_s": verdict["elapsed_s"],
              "supervisor": doctor_proc,
              "hang": {"status": hang_verdict["status"], "reason": hang_verdict["reason"],
                       "elapsed_s": hang_verdict["elapsed_s"], "wall_s": hang_s,
                       "supervisor": hang_proc}})
        rt = verdict["aot_cache"] or {}
        if not (verdict["ok"] and doctor_proc == {"rc": 0, "torch_loaded": False,
                                                  "cuda_initialized": False}
                and (probe.get("launches") == 1 or not card)
                and rt.get("bit_identical") and rt.get("dlopen_ok", not card)
                and plan_line.get("ok")
                and plan_line.get("profile") == (PLAN_PROFILE if card else "cpu-test")
                and plan_line["predicted_peak_hbm_bytes"]
                >= plan_line["probe_measured_peak_bytes"] > 0
                and verdict["mutation"]["second_pass_builds"] == 0):
            raise AssertionError(f"ops: doctor {verdict}, supervisor {doctor_proc}")
        if (hang_proc["rc"], hang_verdict["status"]) != (1, "timeout") \
                or hang_proc["cuda_initialized"] or hang_verdict["elapsed_s"] > 5 + 2 + 1:
            raise AssertionError(f"ops: doctor hang {hang_verdict}, {hang_proc}, "
                                 f"{hang_s:.1f} s")

        (damaged_doc,) = ops_wait(damaged, "damaged child")
        damaged_s = time.perf_counter() - t_damaged

        # ---- timed windows, no child running ---------------------------------
        pol = ServeSession(index, resilience=ResiliencePolicy(batch_deadline_s=1.0,
                                                              max_retries=2),
                           device=device)
        sizes = inputs["streams"]["a_256"]
        stream, r0 = [], 0
        for n in sizes:
            stream.append(Qs[r0:r0 + n])
            r0 += n
        window = stream * -(-SERVE_MIN_BATCHES // len(stream))
        pol.warm(sorted(set(sizes)))
        plain.warm(sorted(set(sizes)))
        recorder = obs_spans.FlightRecorder(os.path.join(tmp, "windows.jsonl"),
                                            fresh=True)
        configs = (("plain", plain, None), ("policy", pol, None),
                   ("policy+flight", pol, recorder))
        runs = {name: [] for name, _, _ in configs}
        ref = None
        for _ in range(OPS_WINDOWS):
            for name, ses, rec in configs:
                obs_spans.set_recorder(rec)
                w = ops_window(ses, window)
                obs_spans.set_recorder(None)
                ref = ref or w["results"]
                w["bit_for_bit"] = ops_same(w.pop("results"), ref)
                runs[name].append(w)

        for name, ws in runs.items():
            emit({"phase": "ops_overhead", "config": name, "batches": len(window),
                  "qps": [w["qps"] for w in ws], "p50_ms": [w["p50_ms"] for w in ws],
                  "p99_ms": [w["p99_ms"] for w in ws],
                  "host_ms_median": [w["host_ms"] for w in ws]})
            if not all(w["bit_for_bit"] for w in ws):
                raise AssertionError(f"ops: {name} windows differ from the plain "
                                     "session")
        wrec = obs_spans.read_flight(os.path.join(tmp, "windows.jsonl"))
        if obs_spans.validate_flight(wrec):
            raise AssertionError("ops: the windows' flight record does not validate")
        # each rung: q/s, p99, recall@10 (tie-aware, against the f64 keys of
        # the centered rows with the kernels' own zero rule)
        picks = inputs["picks"]
        od, oi = ops_oracle(inputs["Xc64"], inputs["Qc64"][picks], device)
        rung_ids = {}
        for lb, ses in rungs.items():
            ses.warm(sorted(set(sizes)))
            w = ops_window(ses, stream)
            ids = np.concatenate([r.ids for r in w.pop("results")])
            rung_ids[lb] = ids
            rec = tie_recall(ids[picks], od, oi)
            emit({"phase": "ops_rung", "index": "pallas/tiles/exact", "rung": lb,
                  "qps": w["qps"], "p50_ms": w["p50_ms"], "p99_ms": w["p99_ms"],
                  "recall_at_10": rec})
            if rec < (1.0 if lb == FULL_RUNG else RECALL_GATE):
                raise AssertionError(f"ops: rung {lb} recall@10 {rec}")
        if not np.array_equal(rung_ids[floor], rung_ids["mixed"]):
            raise AssertionError(f"ops: {floor} differs from the mixed rung")
        sample = np.linspace(0, IVF_QUERIES - 1, IVF_ORACLE_ROWS).astype(np.int64)
        iod, ioi = ivf_oracle(Xs, Qv[sample], device)
        ibatches = [Qv[s:s + IVF_BATCH] for s in range(0, len(Qv), IVF_BATCH)]
        for lb, ses in irungs.items():
            ses.warm(sorted({len(b) for b in ibatches}))
            w = ops_window(ses, ibatches)
            ids = np.concatenate([r.ids for r in w.pop("results")])
            rec = tie_recall(ids[sample], iod, ioi)
            emit({"phase": "ops_rung", "index": "ivf/sift:100000/p256", "rung": lb,
                  "nprobe": ses.cfg.nprobe, "qps": w["qps"], "p50_ms": w["p50_ms"],
                  "p99_ms": w["p99_ms"], "recall_at_10": rec,
                  "recall_target": ivf.cfg.recall_target})
            if lb == FULL_RUNG and rec < 0.95:
                raise AssertionError(f"ops: ivf full rung recall@10 {rec}")

        emit({"phase": "ops_cache_damaged", "child": damaged_doc,
              "wall_s": damaged_s, "truncated": OPS_TRUNCATED})
        if card and (damaged_doc["aot_cache_errors_total"],
                     damaged_doc["nvcc_builds_total"],
                     damaged_doc["aot_cache_hits_total"]) != (1, 1, n_libs - 1):
            raise AssertionError(f"ops: the damaged child {damaged_doc}")
        if damaged_doc["digest"] != cold_doc["digest"]:
            raise AssertionError("ops: the damaged child's results differ")
        emit({"phase": "ops_done", "seconds": time.perf_counter() - t_phase})
        if keep_cache is not None:
            # the warm cache the frontend phase's spawned replicas load from
            shutil.copytree(cache_a, keep_cache)
    finally:
        obs_spans.set_recorder(None)
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


FE_TENANTS = 8  # tenant streams of the front end's load
FE_ROWS = (16, 256)  # rows a request (raw f32)
# per-tenant offered requests/s of each size, lowest first: 16-row
# requests at 0.5k-33k rows/s in all, 256-row ones at 8k-131k
FE_RATES = {16: (4.0, 32.0, 256.0), 256: (4.0, 16.0, 64.0)}
FE_SECONDS = 1.0  # a rate's open-loop schedule (requests = rate x this, >= 8)
FE_CHECK = 4  # requests a tenant in the checked pass (16 and 256 rows alternated)
FE_SHED_ROWS = 4096  # the overload front end's shed threshold
FE_SLOW_S = 0.06  # the injected slow dispatch of the overload burst
FE_BURST_S = 0.5  # the burst's length
FE_CHILD_BOOT_S = 300  # a spawned replica's limit to join the rotation


def fe_post(url, path, body, headers, timeout=60):
    """(status, JSON body) of one POST, HTTP errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=body, headers=headers,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def fe_get(url, path, timeout=10):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read())


def fe_query(url, tenant, q):
    """One raw-f32 POST /query: (dists f32, ids), raising on any non-200."""
    status, doc = fe_post(url, "/query", np.ascontiguousarray(q, "<f4").tobytes(),
                          {"Content-Type": "application/octet-stream",
                           "X-Tenant": tenant})
    if status != 200 or doc["rows"] != q.shape[0]:
        raise AssertionError(f"frontend: /query answered {status}: {doc}")
    return np.asarray(doc["dists"], np.float32), np.asarray(doc["ids"], np.int32)


def fe_checked_requests(Qs):
    """The checked pass: FE_TENANTS tenants x FE_CHECK requests of
    consecutive query rows, 16 and 256 rows alternated."""
    reqs, at = [], 0
    for t in range(FE_TENANTS):
        for i in range(FE_CHECK):
            rows = FE_ROWS[(t + i) % 2]
            reqs.append((f"tenant-{t}", at, at + rows))
            at += rows
    return reqs


def fe_concurrent(url, reqs, Qs):
    """Every request of ``reqs`` posted at once (one thread each, so the
    server coalesces them across tenants): their answers, in order."""
    import threading

    out = [None] * len(reqs)
    errors = []

    def one(i, tenant, lo, hi):
        try:
            out[i] = fe_query(url, tenant, Qs[lo:hi])
        except Exception as e:  # noqa: BLE001 - re-raised below, named
            errors.append(f"{tenant} rows {lo}:{hi}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i, *r), daemon=True)
               for i, r in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"frontend: checked pass failed: {errors[:3]}")
    return out


def fe_metrics(prefix) -> dict:
    """The registry's metrics whose sample name starts with ``prefix``."""
    from mpi_knn_tpu_torch.obs.metrics import get_registry

    return {k: v for k, v in get_registry().snapshot()["metrics"].items()
            if k.startswith(prefix)}


def fe_alone_window(session, rows, Qs, n=40) -> dict:
    """The session alone on ``rows``-row batches (no front end): q/s and
    p50 / p99 of its dispatch -> retire latency."""
    session.reset_stats()
    batches = [Qs[(i * rows) % (len(Qs) - rows):][:rows] for i in range(n)]
    t0 = time.perf_counter()
    for _ in session.stream(batches):
        pass
    wall = time.perf_counter() - t0
    lats = 1e3 * np.asarray(session.latencies)
    return {"qps": session.queries_served / wall,
            "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99))}


def frontend_phase(device, X, inputs, cache_dir) -> dict:
    """The serving front end at the serve phase's deployment (the 60000x784
    pallas tiles exact index, k=10, bucket base 1024, depth 2) under a
    ResiliencePolicy:

    - (a) ``Frontend`` + ``FrontendHTTPServer`` on port 0, warmed over the
      bucket ladder. A checked pass (FE_TENANTS tenants x FE_CHECK
      requests of 16 and 256 rows, all posted at once) answers each
      request bit for bit as the session alone answers its rows, at
      recall@10 = 1.0 against an f64 oracle with the kernels' zero rule;
      then ``loadgen.run_http`` (FE_TENANTS tenants, raw f32) at three
      offered rates of each size, q/s and p50 / p99 beside the session
      alone on batches of that size; the batch fill histogram. K1 and its
      prologue ``stage_tf32_split`` launched (counts set to 0 before);
    - (b) overload: in-process bursts past FE_SHED_ROWS under injected slow
      dispatches shed to the mixed rung (K1[c] and ``stage_bf16``
      launched), every admitted request served, and the ladder recovers
      to full; the shed and recovery lags;
    - (c) online mutation over HTTP on a serial index with headroom (the
      pallas layout takes no live mutation): POST /upsert, a query near an
      upserted row returns its new id; POST /delete, the id is gone; a
      sequence gap is 409; ``mutate --url`` does the same as a process;
    - (d) ``router --spawn 2`` as a process, its children ``serve`` on the
      same data (``--data mnist --limit M_FULL``) with the warm kernel
      cache ``cache_dir``: both join the rotation; the checked pass
      through the router answers as (a)'s, bit for bit; ``loadgen``
      through the router and against one replica (q/s; both replicas
      share the card); one child SIGKILLed under load: no client error,
      the child restarted, rejoined with its ``applied_seq`` caught up by
      replay (a mutation the pallas layout refuses with 400 consumes its
      seq as an apply would); the router stopped by SIGTERM, its children
      gone.

    Returns the launch counts of (a) and (b)."""
    import signal
    import threading

    import torch

    from mpi_knn_tpu_torch import KNNConfig, ServeSession, build_index
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.frontend import (
        Frontend,
        FrontendHTTPServer,
        Rejection,
        SLOPolicy,
        loadgen,
    )
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy, install_faults

    t_phase = time.perf_counter()
    card = device.type == "cuda"
    platform = "cuda" if card else "cpu"
    Qs = inputs["Qs"]
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="tknn-fe-")
    servers, fronts, procs, child_pids = [], [], [], set()
    try:
        # ---- (a) the front end over HTTP --------------------------------
        index = build_index(X, KNNConfig(k=K, backend="pallas",
                                         query_bucket=SERVE_BUCKET,
                                         dispatch_depth=2), device=device)
        t0 = time.perf_counter()
        fe = Frontend(ServeSession(index, resilience=ResiliencePolicy(),
                                   device=device),
                      SLOPolicy(max_batch_rows=SERVE_BUCKET, max_wait_s=0.002,
                                max_queue_rows=65536)).start()
        fronts.append(fe)
        warm_s = time.perf_counter() - t0
        srv = FrontendHTTPServer(fe, port=0).start()
        servers.append(srv)
        health = fe_get(srv.url, "/healthz")
        emit({"phase": "frontend_warm", "seconds": warm_s,
              "warm_report": fe.session.warm_report, "ladder": health["ladder"],
              "peak_hbm_bytes": health["peak_hbm_bytes"],
              "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                       if card else None)})
        reqs = fe_checked_requests(Qs)
        reset_counts()
        answers = fe_concurrent(srv.url, reqs, Qs)
        runs = {}
        for rows in FE_ROWS:
            for rate in FE_RATES[rows]:
                runs[(rows, rate)] = loadgen.run_http(
                    srv.url, tenants=FE_TENANTS, qps=rate,
                    n_requests=max(8, int(rate * FE_SECONDS)), rows=rows,
                    lo=0.0, hi=255.0, timeout_s=120)
        sync_all()
        counts_a = {k: v for k, v in read_counts().items() if v}
        fill = {k: {f: v[f] for f in ("buckets", "counts", "count")}
                for k, v in fe_metrics("frontend_batch_fill_rows").items()}
        # the session alone: each checked request's rows as its own batch
        alone = ServeSession(index, device=device)
        want = []
        for _, lo, hi in reqs:
            want += alone.submit(Qs[lo:hi])
        want += alone.drain()
        same = all(np.array_equal(d, w.dists) and np.array_equal(i, w.ids)
                   for (d, i), w in zip(answers, want))
        rows_checked = reqs[-1][2]
        picks = np.linspace(0, rows_checked - 1, 512).astype(np.int64)
        od, oi = ops_oracle(inputs["Xc64"], inputs["Qc64"][picks], device)
        ids_all = np.concatenate([i for _, i in answers])
        rec = tie_recall(ids_all[picks], od, oi)
        emit({"phase": "frontend_checked", "requests": len(reqs),
              "rows": rows_checked, "bit_for_bit_session": same,
              "recall_at_10": rec, "launches": counts_a})
        if not same:
            raise AssertionError("frontend: HTTP answers differ from the session's")
        if rec < 1.0:
            raise AssertionError(f"frontend: recall@10 {rec} < 1.0")
        need = ("fused_knn_tiles", "stage_tf32_split")
        if card and not all(counts_a.get(n, 0) > 0 for n in need):
            raise AssertionError(f"frontend: launches {counts_a} lack {need}")
        alone_w = {rows: fe_alone_window(alone, rows, Qs) for rows in FE_ROWS}
        for (rows, rate), rep in runs.items():
            emit({"phase": "frontend_http", "rows": rows, "tenants": FE_TENANTS,
                  "offered_rps": rep["offered_qps_total"],
                  "offered_rows_per_s": rep["offered_qps_total"] * rows,
                  "achieved_rps": rep["achieved_rps"],
                  "qps": rep["achieved_qps_rows"], "p50_ms": rep["p50_ms"],
                  "p99_ms": rep["p99_ms"], "rejected": rep["rejected"],
                  "errors": rep["errors"], "wall_s": rep["wall_s"],
                  "session_alone": alone_w[rows]})
            if rep["errors"] or rep["rejected"]:
                raise AssertionError(f"frontend: load at {rows}x{rate}: {rep}")
        emit({"phase": "frontend_fill", "histogram": fill,
              "batches_by_reason": {k: v["value"] for k, v in
                                    fe_metrics("frontend_batches_total").items()}})

        # ---- (b) overload: shed to the mixed rung and recover ----------
        ses_b = ServeSession(index, resilience=ResiliencePolicy(), device=device)
        fe_b = Frontend(ses_b, SLOPolicy(
            max_batch_rows=SERVE_BUCKET, max_wait_s=0.002, max_queue_rows=1 << 20,
            shed_queue_rows=FE_SHED_ROWS, shed_hold_s=0.05,
            recover_hold_s=0.25)).start()
        fronts.append(fe_b)
        batch = Qs[:OPS_BATCH]
        reset_counts()
        tickets = []
        with install_faults({"serve-batch": ("slow", FE_SLOW_S)}):
            t_start = time.monotonic()
            while time.monotonic() - t_start < FE_BURST_S:
                for t in range(FE_TENANTS):
                    out = fe_b.submit(f"tenant-{t}", batch)
                    if isinstance(out, Rejection):
                        raise AssertionError(f"frontend: burst refused {out}")
                    tickets.append(out)
                time.sleep(0.02)
            t_end = time.monotonic()
            for tk in tickets:
                d, _ = tk.result(timeout=120)
                if not np.isfinite(d).all():
                    raise AssertionError("frontend: a burst answer is not finite")
            t_served = max(tk.done_s for tk in tickets)
            deadline = t_end + 120
            while time.monotonic() < deadline:
                st = fe_b.stats()
                if st["rung"] == "full" and st["queue_rows"] == 0 and st["recoveries"]:
                    break
                time.sleep(0.01)
        sync_all()
        counts_b = {k: v for k, v in read_counts().items() if v}
        sheds, recs = fe_b.scheduler.sheds, fe_b.scheduler.recoveries
        emit({"phase": "frontend_overload", "requests": len(tickets),
              "rows": len(tickets) * OPS_BATCH, "burst_s": t_end - t_start,
              "sheds": sheds, "recoveries": recs,
              "shed_lag_s": sheds[0]["t_s"] - t_start if sheds else None,
              "served_s": t_served - t_end,
              "recovery_lag_s": recs[-1]["t_s"] - t_served if recs else None,
              "final_rung": ses_b.rung, "launches": counts_b})
        if not sheds or sheds[0]["rung"] != "mixed" or ses_b.rung != "full":
            raise AssertionError(f"frontend: overload walk {sheds} / {recs}")
        if card and not all(counts_b.get(n, 0) > 0 for n in (
                "fused_knn_tiles[compress]", "stage_bf16")):
            raise AssertionError(f"frontend: the shed rung launched {counts_b}")
        fe_b.stop()

        # ---- (c) online mutation over HTTP (serial layout) -------------
        sidx = build_index(X, KNNConfig(k=K, backend="serial",
                                        query_bucket=SERVE_BUCKET,
                                        bucket_headroom=0.01,
                                        mutation_bucket=MUT_BUCKET), device=device)
        fe_c = Frontend(ServeSession(sidx, device=device), SLOPolicy(
            max_batch_rows=SERVE_BUCKET, max_wait_s=0.002,
            max_queue_rows=65536)).start()
        fronts.append(fe_c)
        srv_c = FrontendHTTPServer(fe_c, port=0).start()
        servers.append(srv_c)
        R, _ = make_mnist_like(MUT_BUCKET, seed=9)
        new = MUT_ID_BASE + np.arange(MUT_BUCKET)
        jhdr = {"Content-Type": "application/json", "X-Tenant": "writer"}
        t0 = time.perf_counter()
        s_up, up = fe_post(srv_c.url, "/upsert", json.dumps(
            {"ids": new.tolist(), "rows": R.tolist()}).encode(),
            {**jhdr, "X-Mutation-Seq": "1"})
        upsert_ms = 1e3 * (time.perf_counter() - t0)
        sel = np.array([0, 7, MUT_BUCKET - 1])
        _, got = fe_query(srv_c.url, "reader", R[sel] + MUT_OFFSET)
        s_del, dl = fe_post(srv_c.url, "/delete", json.dumps(
            {"ids": [int(new[7])]}).encode(), {**jhdr, "X-Mutation-Seq": "2"})
        _, after = fe_query(srv_c.url, "reader", R[7:8] + MUT_OFFSET)
        s_gap, gap = fe_post(srv_c.url, "/upsert", json.dumps(
            {"ids": [int(new[0])], "rows": R[:1].tolist()}).encode(),
            {**jhdr, "X-Mutation-Seq": "5"})
        applied = fe_get(srv_c.url, "/healthz")["applied_seq"]
        R2, _ = make_mnist_like(64, seed=10)
        np.save(os.path.join(tmp, "r2.npy"), R2)
        base2 = MUT_ID_BASE + 1000
        cli = [sys.executable, "-m", "mpi_knn_tpu_torch", "mutate", "--url",
               srv_c.url, "--tenant", "cli"]
        cli_up = subprocess.run(cli + ["--upsert-rows", os.path.join(tmp, "r2.npy"),
                                       "--ids", f"{base2}:{base2 + 64}"],
                                cwd=here, capture_output=True, text=True,
                                timeout=300)
        _, got2 = fe_query(srv_c.url, "reader", R2[3:4] + MUT_OFFSET)
        cli_del = subprocess.run(cli + ["--delete", str(base2 + 3)], cwd=here,
                                 capture_output=True, text=True, timeout=300)
        _, after2 = fe_query(srv_c.url, "reader", R2[3:4] + MUT_OFFSET)
        emit({"phase": "frontend_mutation", "upsert": {"status": s_up, **up},
              "upsert_ms": upsert_ms, "first_ids": got[:, 0].tolist(),
              "delete": {"status": s_del, **dl},
              "after_delete_ids": after[0].tolist(),
              "gap": {"status": s_gap, **gap}, "applied_seq": applied,
              "cli_upsert_rc": cli_up.returncode, "cli_first_id": int(got2[0, 0]),
              "cli_delete_rc": cli_del.returncode,
              "cli_after_delete_ids": after2[0].tolist()})
        checks = {
            "upsert": s_up == 200 and up["upserted"] == MUT_BUCKET
            and up["applied_seq"] == 1,
            "new ids first": got[:, 0].tolist() == new[sel].tolist(),
            "delete": s_del == 200 and dl["deleted"] == 1,
            "deleted id gone": int(new[7]) not in after[0].tolist(),
            "gap 409": s_gap == 409 and gap["error"] == "seq-gap" and applied == 2,
            "cli upsert": cli_up.returncode == 0 and int(got2[0, 0]) == base2 + 3,
            "cli delete": cli_del.returncode == 0
            and base2 + 3 not in after2[0].tolist(),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"frontend: online mutation failed {bad}: "
                                 f"{cli_up.stderr[-2000:]}{cli_del.stderr[-2000:]}")
        srv_c.stop()
        servers.remove(srv_c)
        fe_c.stop()

        # ---- (d) the router and its spawned replicas, as processes ----
        ready = os.path.join(tmp, "router.url")
        log = open(os.path.join(tmp, "router.log"), "w")
        router = subprocess.Popen(
            [sys.executable, "-m", "mpi_knn_tpu_torch", "router", "--spawn", "2",
             "--cache-dir", cache_dir, "--workdir", os.path.join(tmp, "rt"),
             "--port", "0", "--ready-file", ready, "--probe-interval-ms", "200",
             "-q", "--", "--data", "mnist", "--limit", str(len(X)), "--k", str(K),
             "--backend", "pallas", "--bucket", str(SERVE_BUCKET),
             "--platform", platform],
            cwd=here, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        procs.append(router)
        t0 = time.perf_counter()
        while not os.path.exists(ready):
            if router.poll() is not None or time.perf_counter() - t0 > 60:
                raise AssertionError("frontend: the router did not start")
            time.sleep(0.1)
        rurl = open(ready).read().strip()
        while len(fe_get(rurl, "/healthz")["rotation"]) < 2:
            if time.perf_counter() - t0 > FE_CHILD_BOOT_S:
                raise AssertionError(f"frontend: replicas not in rotation: "
                                     f"{fe_get(rurl, '/healthz')}")
            time.sleep(0.2)
        join_s = time.perf_counter() - t0
        via = fe_concurrent(rurl, reqs, Qs)
        same_router = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                          for a, b in zip(via, answers))
        if not same_router:
            raise AssertionError("frontend: the router's answers differ from (a)'s")
        children = fe_get(rurl, "/healthz")["children"]
        child_pids |= {c["pid"] for c in children.values() if c["pid"]}
        one_url = children["r0"]["url"]
        lg = {}
        for rate in (16.0, 64.0):  # 32.8k and 131k rows/s offered
            for name, url in (("router", rurl), ("one_replica", one_url)):
                lg[f"{name}@{rate:g}"] = loadgen.run_http(
                    url, tenants=FE_TENANTS, qps=rate,
                    n_requests=max(8, int(rate * FE_SECONDS)), rows=256,
                    lo=0.0, hi=255.0, timeout_s=120)
        cli_lg = subprocess.run(
            [sys.executable, "-m", "mpi_knn_tpu_torch", "loadgen", "--url", rurl,
             "--tenants", str(FE_TENANTS), "--qps", "16", "--requests", "8",
             "--rows", "16", "-q", "--report", os.path.join(tmp, "lg.json")],
            cwd=here, capture_output=True, text=True, timeout=300)
        if cli_lg.returncode != 0:
            raise AssertionError(f"frontend: loadgen CLI: {cli_lg.stderr[-2000:]}")
        cli_rep = json.load(open(os.path.join(tmp, "lg.json")))
        # SIGKILL r0 under load; mutate while it is down
        victim_pid = children["r0"]["pid"]
        out = {}
        load = threading.Thread(target=lambda: out.update(rep=loadgen.run_http(
            rurl, tenants=FE_TENANTS, qps=16.0, n_requests=48, rows=16,
            lo=0.0, hi=255.0, timeout_s=120)), daemon=True)
        load.start()
        time.sleep(0.5)
        os.kill(victim_pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        load.join(300)
        while fe_get(rurl, "/healthz")["rotation"] != ["r1"]:
            if time.perf_counter() - t_kill > 60:
                raise AssertionError("frontend: the killed replica stayed in rotation")
            time.sleep(0.05)
        s_m, m_doc = fe_post(rurl, "/upsert", json.dumps(
            {"ids": [1], "rows": [[0.0] * X.shape[1]]}).encode(), jhdr)
        while True:
            h = fe_get(rurl, "/healthz")
            pid_now = h["children"]["r0"]["pid"]
            child_pids |= {c["pid"] for c in h["children"].values() if c["pid"]}
            if (len(h["rotation"]) == 2 and pid_now not in (None, victim_pid)
                    and all(r["applied_seq"] == h["seq"] for r in h["replicas"].values())):
                break
            if time.perf_counter() - t_kill > FE_CHILD_BOOT_S:
                raise AssertionError(f"frontend: r0 did not rejoin: {h}")
            time.sleep(0.2)
        rejoin_s = time.perf_counter() - t_kill
        after_kill = fe_concurrent(rurl, reqs[:8], Qs)
        same_after = all(np.array_equal(a[1], b[1]) for a, b in zip(after_kill, answers))
        kill_rep = out.get("rep", {})
        keep = ("offered_qps_total", "achieved_rps", "achieved_qps_rows",
                "p50_ms", "p99_ms", "errors", "wall_s")
        emit({"phase": "frontend_router", "join_s": join_s,
              "bit_for_bit_a": same_router,
              "loadgen": {n: {k: r[k] for k in keep} for n, r in lg.items()},
              "loadgen_cli": {k: cli_rep["rows"][0][k] for k in keep},
              "kill": {"errors": kill_rep.get("errors"),
                       "by_status": kill_rep.get("by_status"),
                       "served": sum(kill_rep.get("per_tenant", {}).values())},
              "mutation_while_down": {"status": s_m, **m_doc},
              "rejoin_s": rejoin_s, "seq": h["seq"],
              "replicas": h["replicas"], "bit_for_bit_after_rejoin": same_after})
        if kill_rep.get("errors") != 0 or kill_rep.get("rejected") != 0 or \
                sum(kill_rep.get("per_tenant", {}).values()) != FE_TENANTS * 48:
            raise AssertionError(f"frontend: load through the kill: {kill_rep}")
        if s_m != 400 or h["seq"] != 1 or not same_after:
            raise AssertionError(f"frontend: replay after rejoin {s_m} {h}")
        if any(lg[n]["errors"] for n in lg):
            raise AssertionError(f"frontend: router loadgen errors {lg}")
        pids = [c["pid"] for c in h["children"].values()]
        router.send_signal(signal.SIGTERM)
        router.wait(timeout=60)
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        if router.returncode != 0 or alive:
            raise AssertionError(f"frontend: router exit {router.returncode}, "
                                 f"children left {alive}")
        emit({"phase": "frontend_done", "seconds": time.perf_counter() - t_phase})
        return {"a": counts_a, "b": counts_b}
    finally:
        for s in servers:
            s.stop()
        for f in fronts:
            f.stop()
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        for pid in child_pids:  # a replica runs in a session of its own
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the profile surface (PR 17): trace launches against the counters -----
PROF_BATCHES = 8  # 256-row batches a profiled serving window takes
PROF_BATCH = 256


def profile_window(name, out) -> dict:
    """Gate one profiled window's report (``ServeSession.profile``'s, or
    ``attribute_trace`` beside the counters' increments): the trace's
    kernel launches equal the launch counters', the categories sum to
    ``busy_total_ms``, that total is the device plane's time counted once
    per stream (no event on a stream overlaps another) and lies within the
    window's wall time, nothing was built inside the window. Emits its
    line and returns it."""
    from mpi_knn_tpu_torch.obs.kineto import (
        find_traces,
        kernel_counts,
        kernel_symbol,
        launch_mismatches,
        parse_trace,
        stream_busy_ps,
        stream_overlaps,
    )

    events = [e for f in find_traces(out["trace_dir"]) for e in parse_trace(f)]
    counted = out["kernel_launches"]
    miss = launch_mismatches(events, counted)
    hand = {s: n for s, n in kernel_counts(events).items()
            if s.endswith("_kernel") or "kernel_" in s}
    top = {}
    for op, ms in out.get("top_ops_ms", {}).items():
        top[kernel_symbol(op)] = top.get(kernel_symbol(op), 0.0) + ms
    busy = out.get("busy_total_ms")
    summed_ps, union_ps = stream_busy_ps(events, out.get("plane"))
    summed, union = summed_ps / 1e9, union_ps / 1e9
    line = {"phase": "profile", "window": name, "plane": out.get("plane"),
            "busy_ms": out.get("busy_ms"), "busy_total_ms": busy,
            "stream_union_ms": union, "wall_ms": out["wall_ms"],
            "idle_share": (None if not busy else 1.0 - busy / out["wall_ms"]),
            "top_ops_ms": top, "kernel_launches": counted,
            "trace_kernel_launches": hand, "mismatches": miss,
            "compiles_in_window": out["compiles_in_window"],
            "dma_wait_ms": out.get("dma_wait_ms"),
            "batches_profiled": out.get("batches_profiled")}
    emit(line)
    if "error" in out or not str(out.get("plane", "")).startswith("/device:GPU"):
        raise AssertionError(f"profile {name}: no device plane: {out}")
    if not counted or miss:
        raise AssertionError(f"profile {name}: the trace's launches differ from "
                             f"the counters': {miss or 'nothing counted'}")
    if abs(sum(out["busy_ms"].values()) - busy) > 1e-6:
        raise AssertionError(f"profile {name}: categories do not sum to the busy total")
    # each category is rounded to 1 us: the total is within that of the
    # events' own sum
    rounding = 1e-3 * (len(out["busy_ms"]) + 1)
    if summed_ps != union_ps or abs(busy - union) > rounding:
        raise AssertionError(
            f"profile {name}: device time counted twice: busy_total_ms {busy}, "
            f"events {summed} ms, their union per stream {union} ms; overlapping "
            f"on one stream: {stream_overlaps(events, out.get('plane'))}")
    if busy > out["wall_ms"]:
        raise AssertionError(f"profile {name}: busy_total_ms {busy} exceeds the "
                             f"window's wall {out['wall_ms']} ms")
    if out["compiles_in_window"]:
        raise AssertionError(f"profile {name}: built inside the window: "
                             f"{out['compiles_in_window']}")
    return line


def profile_phase(device, X, inputs, keep: str | None = None) -> dict:
    """``ServeSession.profile`` over the serve cell's pallas tiles exact
    index (60000x784, k=10, bucket base 1024) and its mixed rung, PROF_BATCHES
    batches of PROF_BATCH rows each; ``attribute_trace`` over the run CLI's
    ``--profile`` trace of a serial twolevel approx run at the main shape
    (the bin minimum's 1770 launches); one P=4 fused-dma ring batch on the
    one card (K4). Each window's gates are ``profile_window``'s. Returns
    the launches each window's trace held, by counter. With ``keep`` the
    traces are written under that directory and kept."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, cli
    from mpi_knn_tpu_torch.obs.attribution import attribute_trace
    from mpi_knn_tpu_torch.obs.metrics import watch_compiles
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy
    from mpi_knn_tpu_torch.serve import ServeSession, build_index
    from mpi_knn_tpu_torch.ops import launch_counts

    t_phase = time.perf_counter()
    tmp = keep or tempfile.mkdtemp(prefix="tknn-profile-")
    Qs = inputs["Qs"]
    batches = [Qs[i * PROF_BATCH:(i + 1) * PROF_BATCH] for i in range(PROF_BATCHES)]
    launches = {}
    try:
        index = build_index(X, KNNConfig(k=K, backend="pallas",
                                         query_bucket=SERVE_BUCKET), device=device)
        sess = ServeSession(index, resilience=ResiliencePolicy(), device=device)
        for rung in ("full", "mixed"):
            if rung == "mixed" and sess.shed_rung(reason="profile") != "mixed":
                raise AssertionError(f"profile: the ladder has no mixed rung: {sess.ladder}")
            out = sess.profile(batches, trace_dir=os.path.join(tmp, rung))
            profile_window(f"pallas/tiles/{rung}", out)
            launches[f"pallas/tiles/{rung}"] = out["kernel_launches"]
        del sess, index
        ring = build_index(X, KNNConfig(k=K, backend="ring-overlap",
                                        ring_fusion="fused", num_devices=4,
                                        query_bucket=SERVE_RING_BUCKET),
                           device=device, mesh=[device] * 4)
        sess = ServeSession(ring, device=device)
        out = sess.profile(batches[:1], trace_dir=os.path.join(tmp, "ring"))
        profile_window("ring/P4/fused-dma", out)
        launches["ring/P4/fused-dma"] = out["kernel_launches"]
        del sess, ring
        # the run CLI's own --profile trace
        tdir = os.path.join(tmp, "run_cli")
        report = os.path.join(tmp, "run_cli.json")
        before = launch_counts()
        with watch_compiles() as built:
            rc = cli.main(["--data", "mnist", "--k", str(K), "--loo",
                           "--backend", "serial", "--topk-method", "approx",
                           "--profile", tdir, "--report", report, "-q"])
        after = launch_counts()
        with open(report) as f:
            phases = json.load(f)["phase_seconds"]
        # the trace holds the knn and vote phases
        wall = 1e3 * (phases["knn"] + phases.get("vote", 0.0))
        out = {**attribute_trace(tdir), "trace_dir": tdir, "wall_ms": wall,
               "kernel_launches": {n: after[n] - before[n] for n in after
                                   if after[n] != before[n]},
               "compiles_in_window": list(built)}
        if rc != 0:
            raise AssertionError(f"profile: the run CLI exited {rc}")
        profile_window("run_cli/serial/twolevel/approx", out)
        launches["run_cli/serial/twolevel/approx"] = out["kernel_launches"]
    finally:
        if keep is None:
            shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "profile_done", "seconds": time.perf_counter() - t_phase})
    return launches


# ---- the sharded clustered index (PR 17): README.md's sharded deployment ---
SHARDS = 4  # the README's --devices 4: the one card named four times
# (store, recall@10 bar): the clustered cell's (the ivf phase's) bars
SHARDED_STORES = (("float32", 0.95), ("int8", 0.95), ("int4", 0.80))
SHARDED_TIGHT_CAP = 32  # a --route-cap under the routing's skew: drops


def sharded_phase(device) -> dict:
    """The README's sharded deployment (``build-index --data sift:100000
    --partitions 256 --backend ring``; ``query --index-load ... --backend
    ring --devices 4 --synthetic 10000 --batch 512``) through the library
    on a mesh naming the card SHARDS times, per store: S = 1 bit for bit
    the unsharded index; S = 4 bit for bit the unsharded index at equal
    nprobe and the same query tile, recall@10 at the store's bar against
    f64; a tight route cap's drops counted and its answers consistent with
    the safe cap's; every served IVF_BATCH-row batch bit for bit the
    one-shot search. On float32 also a sharded upsert / delete chunk with
    the mutate phase's checks, against the same writes into the unsharded
    index. Then the CLI at the visible card count. No kernel runs on the
    path (counts 0)."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, cli
    from mpi_knn_tpu_torch.ivf import (
        build_ivf_index,
        search_ivf,
        search_ivf_sharded,
        shard_ivf_index,
    )
    from mpi_knn_tpu_torch.ivf.sharded import sharded_query_shapes
    from mpi_knn_tpu_torch.serve import ServeSession

    t_phase = time.perf_counter()
    X, Q = ivf_data()
    sample = np.linspace(0, IVF_QUERIES - 1, IVF_ORACLE_ROWS).astype(np.int64)
    od, oi = ivf_oracle(X, Q[sample], device)
    reset_counts()
    results = {}
    mesh = [device] * SHARDS
    for dtype, bar in SHARDED_STORES:
        t0 = time.perf_counter()
        index = build_ivf_index(X, KNNConfig(k=K, partitions=IVF_P, dtype=dtype),
                                device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cfg = index.compatible_cfg(index.cfg)
        d_1, i_1 = search_ivf(index, Q, device=device)
        s1 = shard_ivf_index(index, mesh=[device])
        d1, i1, _ = search_ivf_sharded(s1, Q, device=device)
        t0 = time.perf_counter()
        sidx = shard_ivf_index(index, mesh=mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        q_tile, q_pad, route_cap = sharded_query_shapes(
            cfg, cfg.nprobe, index.bucket_cap, index.dim, IVF_QUERIES, SHARDS)
        d_u, i_u = search_ivf(index, Q, query_tile=q_tile, device=device)
        d4, i4, stats = search_ivf_sharded(sidx, Q, device=device)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d4, i4, stats = search_ivf_sharded(sidx, Q, device=device)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        stats = stats.cpu().numpy()
        rec = tie_recall(i4.cpu().numpy()[sample], od, oi)
        s1_equal = torch.equal(d1, d_1) and torch.equal(i1, i_1)
        s4_equal = torch.equal(d4, d_u) and torch.equal(i4, i_u)
        # a tight cap: drops counted, the answers a subset of the safe ones'
        tight = shard_ivf_index(index, mesh=mesh, route_cap=SHARDED_TIGHT_CAP)
        dt, it, st = search_ivf_sharded(tight, Q, device=device)
        st = st.cpu().numpy()
        dt, it = dt.cpu().numpy(), it.cpu().numpy()
        ds = d4.cpu().numpy()
        told = int(st[:, 0].sum() + st[:, 1].sum()) == q_pad * cfg.nprobe
        consistent = bool(np.isfinite(dt[it >= 0]).all()
                          and (dt >= ds - 1e-6 * np.maximum(1.0, ds)).all()
                          and ((it >= 0) == np.isfinite(dt)).all())
        served = ivf_serve(sidx, Q, device)
        got_d = np.concatenate([b.dists for b in served["checked"]])
        got_i = np.concatenate([b.ids for b in served["checked"]])
        serve_equal = (np.array_equal(got_d, ds)
                       and np.array_equal(got_i, i4.cpu().numpy()))
        xbytes = sum(b.exchange_bytes for b in served["checked"])
        line = {"phase": "ivf_sharded", "store": dtype, "shards": SHARDS,
                "partitions": IVF_P, "per_shard": sidx.per_shard,
                "nprobe": cfg.nprobe, "bucket_cap": index.bucket_cap,
                "build_s": build_s, "shard_s": shard_s,
                "resident_bytes": sidx.nbytes_resident,
                "resident_bytes_per_shard": sidx.shard_nbytes_resident,
                "q_tile": q_tile, "q_pad": q_pad, "route_cap": route_cap,
                "one_shot_ms": statistics.median(times), "one_shot_ms_runs": times,
                "stats": stats.tolist(), "recall_at_10": rec, "recall_bar": bar,
                "s1_bit_equal": s1_equal, "s4_bit_equal_unsharded": s4_equal,
                "tight_cap": SHARDED_TIGHT_CAP, "tight_stats": st.tolist(),
                "tight_dropped": int(st[:, 1].sum()), "tight_all_told": told,
                "tight_consistent": consistent,
                **{k_: v for k_, v in served.items() if k_ != "checked"},
                "batches_equal_one_shot": serve_equal,
                "exchange_bytes_served": xbytes,
                "exchange_bytes_per_batch": xbytes / max(1, served["batches"])}
        emit(line)
        if not (s1_equal and s4_equal and serve_equal):
            raise AssertionError(f"ivf_sharded {dtype}: S=1 {s1_equal}, S=4 "
                                 f"{s4_equal}, served {serve_equal}")
        if rec < bar or int(stats[:, 1].sum()) != 0:
            raise AssertionError(f"ivf_sharded {dtype}: recall@10 {rec} < {bar} "
                                 "or a drop at the safe cap")
        if not (told and consistent and int(st[:, 1].sum()) > 0):
            raise AssertionError(f"ivf_sharded {dtype}: the tight cap's drops "
                                 f"were not counted or its answers are wrong")
        results[dtype] = {"recall": rec, "one_shot_ms": line["one_shot_ms"],
                          "qps": served["qps"]}
        del index, s1, sidx, tight
        torch.cuda.empty_cache()

    # a sharded upsert / delete chunk, beside the same writes unsharded
    mcfg = KNNConfig(k=K, partitions=IVF_P, bucket_headroom=0.5,
                     mutation_bucket=MUT_BUCKET)
    plain = build_ivf_index(X, mcfg, device=device)
    sharded = shard_ivf_index(build_ivf_index(X, mcfg, device=device), mesh=mesh)
    new = mutation_pool()[:MUT_BUCKET]
    ids = np.arange(MUT_ID_BASE, MUT_ID_BASE + MUT_BUCKET)
    gone = np.arange(0, 2 * MUT_BUCKET, 2)
    live = np.arange(1, 2 * MUT_BUCKET, 2)
    outs = []
    for index in (plain, sharded):
        sess = ServeSession(index, device=device)
        before = [t.clone() for t in mut_store(index)]
        sess.upsert(live, X[live])  # a re-upsert of live rows: no change
        same = all(torch.equal(a, b) for a, b in zip(before, mut_store(index)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = sess.upsert(ids, new)
        de = sess.delete(gone)
        torch.cuda.synchronize()
        write_ms = 1e3 * (time.perf_counter() - t0)
        own = list(sess.stream([new + MUT_OFFSET]))[0]
        back = list(sess.stream([X[gone]]))[0]
        outs.append({"reupsert_same": same, "write_ms": write_ms,
                     "own_first": bool((own.ids[:, 0] == ids).all()),
                     "deleted_absent": not np.isin(back.ids, gone).any(),
                     "live": de["live"], "own": own, "back": back})
    p, s = outs
    equal = (np.array_equal(p["own"].ids, s["own"].ids)
             and np.array_equal(p["own"].dists, s["own"].dists)
             and np.array_equal(p["back"].ids, s["back"].ids))
    emit({"phase": "ivf_sharded_mutate", "shards": SHARDS, "chunk": MUT_BUCKET,
          **{f"{n}_{k_}": v for n, o in (("unsharded", p), ("sharded", s))
             for k_, v in o.items() if k_ not in ("own", "back")},
          "sharded_equals_unsharded": equal})
    if not (equal and s["reupsert_same"] and s["own_first"] and s["deleted_absent"]
            and s["live"] == p["live"]):
        raise AssertionError("ivf_sharded: the sharded chunk failed the mutate checks")
    del plain, sharded, outs
    torch.cuda.empty_cache()

    # the CLI at the visible card count
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sift.ivf.npz")
        report = os.path.join(tmp, "q.json")
        rc_b = cli.main(["build-index", "--data", f"sift:{IVF_M}", "--partitions",
                         str(IVF_P), "--k", str(K), "--backend", "ring",
                         "--out", path, "-q"])
        rc_q = cli.main(["query", "--data", f"sift:{IVF_M}", "--index-load", path,
                         "--backend", "ring", "--devices", str(cards),
                         "--synthetic", str(IVF_QUERIES), "--batch",
                         str(IVF_BATCH), "--k", str(K), "-q", "--report", report])
        with open(report) as f:
            summary = json.load(f)
    emit({"phase": "ivf_sharded_cli", "rc": [rc_b, rc_q], "argv": (
        f"query --data sift:{IVF_M} --index-load sift.ivf.npz --backend ring "
        f"--devices {cards} --synthetic {IVF_QUERIES} --batch {IVF_BATCH}"),
        **{k_: summary.get(k_) for k_ in (
            "backend", "queries", "throughput_qps", "latency_p50_ms",
            "latency_p99_ms", "sharded", "peak_hbm_bytes")}})
    if (rc_b, rc_q) != (0, 0) or summary.get("backend") != "ivf-sharded" \
            or summary.get("queries") != IVF_QUERIES:
        raise AssertionError("ivf_sharded: the CLI failed")
    counts = {name: n for name, n in read_counts().items() if n}
    emit({"phase": "ivf_sharded_launches", "launches": counts,
          "seconds": time.perf_counter() - t_phase})
    if counts:
        raise AssertionError(f"ivf_sharded: kernels launched on the path: {counts}")
    return results


# ---- the 2-D dp x ring mesh (PR 17) on the one card -----------------------
MESH2D = (2, 2)
# (label, config overrides, launches a P=2 group's ring makes)
MESH2D_CELLS = (
    ("xla/Tensor.to", {}, {}),
    ("fused/bidir/K3a", {"ring_fusion": "fused", "ring_schedule": "bidir"},
     {"fused_block_merge[exact]": 4, "stage_tf32[wire]": 4}),
    ("fused-dma/K4", {"ring_fusion": "fused"},
     {"fused_round_dma": 2, "stage_tf32_split[ring]": 4}),
    ("fused-grid/K5", {"ring_fusion": "fused", "ring_fused_rotation": "grid"},
     {"fused_rotation_grid": 1, "stage_tf32[wire]": 4}),
)


def mesh2d_phase(device, X, recall) -> dict:
    """The main shape (60000x784, k=10, all pairs) on a 2x2 mesh of the one
    card, per transport: each dp group's rows bit for bit the 1-D P=2 ring
    of the same transport over those rows, recall@10 >= RECALL_GATE (the
    main paths' ``recall``), the launches of the 2-D run equal to the sum
    of the two groups' 1-D runs and to each cell's count a group; the
    device-input ms of the 2-D run and of one group's 1-D run. Returns the
    launches by kernel."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.backends.ring import ring_tiles
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    t_phase = time.perf_counter()
    dp, ring = MESH2D
    mesh = make_mesh2d(dp, ring, devices=[device] * (dp * ring))
    Xd = torch.from_numpy(X).to(device)
    totals = {}
    for label, over, per_group in MESH2D_CELLS:
        cfg = KNNConfig(k=K, backend="ring-overlap", **over)
        # a group's rows: its ranks' query shards of the padded layout
        rows = ring_tiles(cfg, M_FULL, M_FULL, dp, ring)[2] // dp
        reset_counts()
        got = all_knn(Xd, config=cfg, mesh=mesh, device=device)
        sync_all()
        counts = {n: c for n, c in read_counts().items() if c}
        t0 = time.perf_counter()
        all_knn(Xd, config=cfg, mesh=mesh, device=device)
        sync_all()
        ms = 1e3 * (time.perf_counter() - t0)
        group_counts, equal, group_ms = {}, True, []
        for g in range(dp):
            ids = torch.arange(g * rows, min((g + 1) * rows, M_FULL),
                               device=device)
            reset_counts()
            t0 = time.perf_counter()
            one = all_knn(Xd, queries=Xd[ids], query_ids=ids.cpu().numpy(),
                          config=cfg, mesh=[device] * ring, device=device)
            sync_all()
            group_ms.append(1e3 * (time.perf_counter() - t0))
            for n, c in read_counts().items():
                if c:
                    group_counts[n] = group_counts.get(n, 0) + c
            equal &= (torch.equal(got.ids[ids], one.ids)
                      and torch.equal(got.dists[ids], one.dists))
        rec = recall(got.ids)
        want = {n: dp * c for n, c in per_group.items()}
        emit({"phase": "mesh2d", "path": label, "dp": dp, "ring": ring,
              "m": M_FULL, "k": K, "device_input_ms": ms,
              "group_1d_device_input_ms": group_ms, "launches": counts,
              "groups_1d_launches": group_counts, "groups_bit_equal_1d": equal,
              "recall_at_10": rec, "finite": bool(torch.isfinite(got.dists).all())})
        if not equal:
            raise AssertionError(f"mesh2d {label}: a group's rows differ from its 1-D ring")
        if rec < RECALL_GATE:
            raise AssertionError(f"mesh2d {label}: recall@10 {rec} < {RECALL_GATE}")
        if counts != group_counts or counts != want:
            raise AssertionError(f"mesh2d {label}: launches {counts}, the groups' "
                                 f"1-D runs {group_counts}, expected {want}")
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c
    del Xd
    torch.cuda.empty_cache()
    emit({"phase": "mesh2d_done", "seconds": time.perf_counter() - t_phase})
    return totals


MP_PROCESSES = 2  # worker processes on the one card (gloo, blocks via host)
MP_TIMEOUT_S = 300  # a worker's limit: start-up, kernel loads, every form
MP_FORMS = (
    ("fused-dma/K4", {"ring_fusion": "fused"}),
    ("fused/bidir/K3a", {"ring_fusion": "fused", "ring_schedule": "bidir"}),
    ("ring-overlap/xla", {}),
)
MP_RESUMABLE = "resumable/fused-dma"
# a process's boundary moves a rotation, one rank a process: every round
# but the last, each way under bidir (the dma form's last outbox stays)
MP_EXCHANGES = {"fused-dma/K4": MP_PROCESSES - 1,
                "fused/bidir/K3a": 2 * (MP_PROCESSES // 2),
                "ring-overlap/xla": MP_PROCESSES - 1}
# kernels launched once a card (K4 a round, K5 a rotation), the rest once
# a rank
MP_PER_CARD = ("fused_round_dma", "fused_rotation_grid")
# the pod with several ranks a process: MP_RANKS ranks in each of the
# MP_PROCESSES processes (on the one card: cuda:0 named MP_RANKS times in
# each), the forms of MP_FORMS and the grid form (K5 across the processes
# over CUDA IPC), the resumable ring, and --dp 2 over the same ranks
MP_RANKS = 2
MP_P = MP_PROCESSES * MP_RANKS
MP_RANK_FORMS = MP_FORMS + (
    ("fused-grid/K5", {"ring_fusion": "fused", "ring_fused_rotation": "grid"}),)
MP_DP = 2
MP_DP_FORMS = (
    ("dp2/fused-dma/K4", {"ring_fusion": "fused"}),
    ("dp2/fused-grid/K5", {"ring_fusion": "fused", "ring_fused_rotation": "grid"}),
)
# a process's boundary moves at P = MP_P: every round but the last (each
# way under bidir); none for K5 (in-kernel, over IPC) and none where each
# dp group lies inside one process
MP_RANK_EXCHANGES = {"fused-dma/K4": MP_P - 1,
                     "fused/bidir/K3a": 2 * (MP_P // 2),
                     "ring-overlap/xla": MP_P - 1, "fused-grid/K5": 0,
                     "dp2/fused-dma/K4": 0, "dp2/fused-grid/K5": 0}
# the resumable ring at P = MP_P stopped after one round, then resumed:
# rounds 2 .. P-1 one K4 launch each (one card), the last K3a once a rank
# the grid form over the 2 x MP_RANKS pod told apart into two hosts (each
# worker reports a host of its own): K5 over the host proxy at both
# boundaries, one launch a process, the boundary's hops moved by the proxy
MP_HOSTS_FORM = ("fused-grid/K5",
                 {"ring_fusion": "fused", "ring_fused_rotation": "grid"})
MP_HOSTS = ("mp-host-0", "mp-host-1")
# four processes of one rank on two hosts: each has an "ipc" and a proxy link
MP_HOSTS_MIXED = ("mp-host-0", "mp-host-0", "mp-host-1", "mp-host-1")
MP_RANK_RESUMABLE = {
    "stopped": {"fused_round_dma": 1, "stage_tf32_split[ring]": 2 * MP_RANKS},
    "resumed": {"fused_round_dma": MP_P - 2, "fused_block_merge[exact]": MP_RANKS,
                "stage_tf32_split[ring]": 2 * MP_RANKS}}


def multiproc_worker() -> int:
    """One process of the multiproc phase's pod (``python chip_smoke.py
    --multiproc-worker``): joins the process group from the launch
    environment (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``) with ``MP_RANKS`` ranks (env, default 1), builds
    ``make_mnist_like(MP_M)`` on its first card and drives every form of
    MP_FORMS, then the resumable ring stopped after ``MP_STOP`` rounds
    into its own checkpoint directory and resumed, over the mesh of one
    rank a process. With more ranks a process it also drives MP_RANK_FORMS
    and the resumable ring (stopped after 1 round) over the mesh of every
    rank, and MP_DP_FORMS on the --dp 2 grid over the same ranks. With
    ``MP_IVF`` it also searches the saved clustered index in ``MP_DIR``
    sharded one shard a process. Writes ``worker-<id>.json`` (launches,
    ms, the boundary's bytes and seconds, rounds) and ``worker-<id>.npz``
    (the results) into ``MP_DIR``."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d, make_ring_mesh

    out_dir, m = os.environ["MP_DIR"], int(os.environ["MP_M"])
    stop = int(os.environ.get("MP_STOP", "1"))
    ranks = int(os.environ.get("MP_RANKS", "1"))
    told_apart = os.environ.get("MP_HOSTS")
    if told_apart:  # the host this worker reports (the package has no switch)
        import socket

        host = told_apart.split(",")[int(os.environ["JAX_PROCESS_ID"])]
        socket.gethostname = lambda: host
    # "cpu" rehearses the pod on the kernels' plain versions
    info = distributed.init_multihost(timeout_seconds=120,
                                      device=os.environ.get("MP_DEVICE", "cuda"),
                                      local_devices=ranks)
    pid = info["process_id"]
    dev = distributed.pod().card

    def sync():
        for c in dict.fromkeys(distributed.pod().cards):
            if c.type == "cuda":
                torch.cuda.synchronize(c)

    res, arrays = {"info": info, "forms": {}, "ranks": {}}, {}

    def forms(Xd, mesh, table, into, prefix=""):
        for label, over in table:
            cfg = KNNConfig(k=K, backend="ring-overlap", **over)
            reset_counts()
            got = all_knn(Xd, config=cfg, mesh=mesh, device=dev)
            sync()
            counts = {n: c for n, c in read_counts().items() if c}
            distributed.reset_exchange_stats()
            t0 = time.perf_counter()
            all_knn(Xd, config=cfg, mesh=mesh, device=dev)
            sync()
            ms = 1e3 * (time.perf_counter() - t0)
            into[label] = {
                "launches": counts, "device_input_ms": ms,
                "gather_ms": 1e3 * distributed.pod().gather_seconds,
                "boundary": dict(distributed.EXCHANGES)}
            arrays[f"{prefix}{label}/ids"] = got.ids.cpu().numpy()
            arrays[f"{prefix}{label}/dists"] = got.dists.cpu().numpy()

    def resumable(Xd, mesh, stop, into, prefix=""):
        cfg = KNNConfig(k=K, backend="ring-overlap", ring_fusion="fused")
        qids = np.arange(m, dtype=np.int32)
        ck = os.path.join(out_dir, f"ck-{prefix.strip('/')}-proc{pid}" if prefix
                          else f"ck-proc{pid}")
        rounds, rounds2 = [], []
        reset_counts()
        all_knn_ring_resumable(Xd, Xd, qids, cfg, mesh=mesh, checkpoint_dir=ck,
                               stop_after_rounds=stop, device=dev,
                               progress_cb=lambda r, t: rounds.append(r))
        sync()
        first = {n: c for n, c in read_counts().items() if c}
        wrote = os.path.exists(os.path.join(ck, "knn_state.npz"))
        reset_counts()
        d, i = all_knn_ring_resumable(Xd, Xd, qids, cfg, mesh=mesh,
                                      checkpoint_dir=ck, device=dev,
                                      progress_cb=lambda r, t: rounds2.append(r))
        sync()
        into[MP_RESUMABLE] = {
            "launches_stopped": first, "rounds_stopped": rounds,
            "launches": {n: c for n, c in read_counts().items() if c},
            "rounds_resumed": rounds2, "wrote_checkpoint": wrote}
        arrays[f"{prefix}{MP_RESUMABLE}/ids"] = i.cpu().numpy()
        arrays[f"{prefix}{MP_RESUMABLE}/dists"] = d.cpu().numpy()

    def hosts_k5(Xd, mesh):
        """The grid form over the pod told apart into hosts: K5 over the
        host proxy at both boundaries (MP_HOSTS_FORM), a first call with
        the counts set to 0 just before it, then a timed one."""
        from mpi_knn_tpu_torch.backends.ring import ProcessSpan
        from mpi_knn_tpu_torch.parallel import hostlink, ipc

        label, over = MP_HOSTS_FORM
        cfg = KNNConfig(k=K, backend="ring-overlap", **over)
        reset_counts()
        hostlink.reset_proxy_stats()
        got = all_knn(Xd, config=cfg, mesh=mesh, device=dev)
        sync()
        counts = {n: c for n, c in read_counts().items() if c}
        first = dict(hostlink.PROXY)
        hostlink.reset_proxy_stats()
        t0 = time.perf_counter()
        all_knn(Xd, config=cfg, mesh=mesh, device=dev)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        res["hosts"] = {label: {
            "launches": counts, "device_input_ms": ms,
            "gather_ms": 1e3 * distributed.pod().gather_seconds,
            "link_kinds": list(ProcessSpan(mesh).link_kinds()),
            "ipc_mappings": len(ipc._MAPPINGS), "proxy_first": first,
            "proxy": dict(hostlink.PROXY)}}
        arrays[f"hosts/{label}/ids"] = got.ids.cpu().numpy()
        arrays[f"hosts/{label}/dists"] = got.dists.cpu().numpy()

    try:
        X, _ = make_mnist_like(m)
        Xd = torch.from_numpy(X).to(dev)
        if told_apart:
            hosts_k5(Xd, make_ring_mesh(ranks, device=dev))
        else:
            mesh = make_ring_mesh(1, device=dev)
            forms(Xd, mesh, MP_FORMS, res["forms"])
            resumable(Xd, mesh, stop, res["forms"])
            if ranks > 1:
                mesh = make_ring_mesh(ranks, device=dev)
                forms(Xd, mesh, MP_RANK_FORMS, res["ranks"], "ranks/")
                resumable(Xd, mesh, 1, res["ranks"], "ranks/")
                grid = make_mesh2d(MP_DP, ranks * info["num_processes"] // MP_DP,
                                   device=dev)
                forms(Xd, grid, MP_DP_FORMS, res["ranks"], "ranks/")
            if os.environ.get("MP_IVF"):
                from mpi_knn_tpu_torch.ivf import (
                    load_ivf_index,
                    search_ivf_sharded,
                    shard_ivf_index,
                )

                idx = load_ivf_index(os.path.join(out_dir, "index.npz"), device=dev)
                Q = np.load(os.path.join(out_dir, "queries.npy"))
                sidx = shard_ivf_index(idx, mesh=make_ring_mesh(1, device=dev))
                sd, si, stats = search_ivf_sharded(sidx, Q, device=dev)
                arrays["ivf/ids"] = si.cpu().numpy()
                arrays["ivf/dists"] = sd.cpu().numpy()
                arrays["ivf/stats"] = stats.cpu().numpy()
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"worker-{pid}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"worker-{pid}.npz"), **arrays)
    print(f"multiproc worker {pid} done", flush=True)
    return 0


def multiproc_pod(out_dir: str, m: int, processes: int, env=None,
                  worker: str = "--multiproc-worker") -> list:
    """Start ``processes`` workers (``worker``: the flag of
    :func:`multiproc_worker`, or of :func:`sharded_mutation_worker`) against a
    coordinator on a free local port and wait for them all, each within
    MP_TIMEOUT_S; a worker that fails or outlives it fails the pod (every
    worker is killed, and their output is raised). Returns per process
    (json dict, npz arrays, seconds to exit)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    base.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                 "JAX_NUM_PROCESSES": str(processes), "MP_DIR": out_dir,
                 "MP_M": str(m), **(env or {})})
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), worker],
        cwd=here, env=dict(base, JAX_PROCESS_ID=str(p)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(processes)]
    outs, exits = [], []
    try:
        for p in procs:
            left = max(1.0, MP_TIMEOUT_S - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left)[0])
            exits.append(time.perf_counter() - t0)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        partial = [p.communicate()[0] or "" for p in procs]
        raise AssertionError("multiproc workers did not exit within "
                             f"{MP_TIMEOUT_S} s:\n" + "\n".join(outs + partial))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multiproc worker {pid} exited {p.returncode}:\n{out}")
    got = []
    for pid in range(processes):
        with open(os.path.join(out_dir, f"worker-{pid}.json")) as f:
            doc = json.load(f)
        got.append((doc, dict(np.load(os.path.join(out_dir, f"worker-{pid}.npz"))),
                    exits[pid]))
    return got


def _single_forms(device, Xd, mesh, table) -> dict:
    """Each form of ``table`` on ``mesh`` in this process: label -> (ids,
    dists, launches, device-input ms of a second run)."""
    import torch

    from mpi_knn_tpu_torch import KNNConfig, all_knn

    out = {}
    for label, over in table:
        cfg = KNNConfig(k=K, backend="ring-overlap", **over)
        reset_counts()
        one = all_knn(Xd, config=cfg, mesh=mesh, device=device)
        sync_all()
        counts = {n: c for n, c in read_counts().items() if c}
        t0 = time.perf_counter()
        all_knn(Xd, config=cfg, mesh=mesh, device=device)
        sync_all()
        out[label] = (one.ids.cpu().numpy(), one.dists.cpu().numpy(), counts,
                      1e3 * (time.perf_counter() - t0))
    del one
    torch.cuda.empty_cache()
    return out


def multiproc_phase(device, X, recall, ranks: int = 1):
    """The main shape through MP_PROCESSES processes on the one card: a
    global ring of one rank a process (gloo, the boundary's blocks staged
    through host memory), each form of MP_FORMS and the resumable
    fused-dma ring stopped after 1 round into per-process checkpoint
    directories and resumed. Gates: every process's ids and distances bit
    for bit the single-process P = 2 ring on [device, device] (the
    resumable run: the single-process fused-dma ring), recall@10 >=
    RECALL_GATE, the resumed rounds [2] with only process 0's directory
    holding a file, each process's launches: K4 the single process's
    (one card either way), every per-rank kernel half of it, and each
    form's boundary moves MP_EXCHANGES. With ``ranks`` > 1 the same pod
    also drives ``ranks`` ranks a process (:func:`multiproc_ranks_gates`).
    Returns the launches of process 0 by kernel, summed over the forms, of
    the one-rank pod and of the pod of ``ranks`` ranks a process, and (with
    ``ranks`` > 1) the grid form's references for
    :func:`multiproc_hosts_phase`: the single-process ring's (ids, dists,
    ms) and the IPC form's (ids, dists, ms a process, launches)."""
    import torch

    t_phase = time.perf_counter()
    m = X.shape[0]
    Xd = torch.from_numpy(X).to(device)
    single = _single_forms(device, Xd, [device] * MP_PROCESSES, MP_FORMS)
    single[MP_RESUMABLE] = single["fused-dma/K4"]
    single_ranks = {}
    if ranks > 1:
        from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

        P = MP_PROCESSES * ranks
        single_ranks = _single_forms(device, Xd, [device] * P, MP_RANK_FORMS)
        single_ranks[MP_RESUMABLE] = single_ranks["fused-dma/K4"]
        single_ranks.update(_single_forms(
            device, Xd, make_mesh2d(MP_DP, P // MP_DP, devices=[device] * P),
            MP_DP_FORMS))
    del Xd
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="tknn-mp-")
    t_pod = time.perf_counter()
    try:
        got = multiproc_pod(tmp, m, MP_PROCESSES, env={"MP_RANKS": str(ranks)})
        dirs = [os.path.exists(os.path.join(tmp, f"ck-proc{p}", "knn_state.npz"))
                for p in range(MP_PROCESSES)]
        rank_dirs = [os.path.exists(os.path.join(tmp, f"ck-ranks-proc{p}",
                                                 "knn_state.npz"))
                     for p in range(MP_PROCESSES)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pod_seconds = time.perf_counter() - t_pod
    infos = [doc["info"] for doc, _, _ in got]
    emit({"phase": "multiproc_startup", "processes": MP_PROCESSES,
          "ranks_a_process": ranks, "backend": infos[0]["backend"],
          "cards": [i["cards"] for i in infos],
          "startup_seconds": [i["startup_seconds"] for i in infos],
          "worker_exit_seconds": [e for _, _, e in got], "pod_seconds": pod_seconds})
    if infos[0]["backend"] != "gloo":
        raise AssertionError(f"processes sharing one card must take gloo: {infos[0]}")
    totals = _multiproc_gates(got, single, recall, "forms", "", MP_PROCESSES,
                              MP_EXCHANGES, dirs)
    rank_totals = {}
    if ranks > 1:
        rank_totals = multiproc_ranks_gates(got, single_ranks, recall, ranks,
                                            rank_dirs)
    emit({"phase": "multiproc_done", "seconds": time.perf_counter() - t_phase})
    k5 = None
    if ranks > 1:  # the single-process K5 ring and the IPC form, for multiproc_hosts
        label = MP_HOSTS_FORM[0]
        wi, wd, wcounts, wms = single_ranks[label]
        k5 = {"single": (wi, wd, wms, wcounts),
              "ipc": (got[0][1][f"ranks/{label}/ids"],
                      got[0][1][f"ranks/{label}/dists"],
                      [doc["ranks"][label]["device_input_ms"] for doc, _, _ in got],
                      got[0][0]["ranks"][label]["launches"])}
    return totals, rank_totals, k5


def multiproc_hosts_phase(X, recall, k5, cards=None, hosts=MP_HOSTS) -> dict:
    """The grid form across hosts: the main shape through a pod of
    len(hosts) processes whose workers report the hosts ``hosts`` (env
    ``MP_HOSTS``), MP_P ranks in all. With the default two hosts (2 x 2)
    both boundary links of each process are proxy links; with
    MP_HOSTS_MIXED (4 x 1) each process has one "ipc" link and one proxy
    link. K5 runs over the host proxy (``parallel/hostlink.py``) at every
    proxy link. On the one card (``cards`` None) the processes share it
    (gloo); on four cards (``nccl+gloo``) each process drives its own.
    Gates: each process's ids and distances bit for bit the single-process
    K5 ring's and the IPC form's (``k5`` from :func:`multiproc_phase`),
    recall@10 >= RECALL_GATE, each link's kind by the hosts, one K5 launch
    a card a process and the single process's other launches shared out,
    no CUDA IPC mapping for a proxy link, the proxy's bytes a process
    (P - 1) hops of block + ids + norms on each proxy link, and the whole
    call a process under TIMEOUT_S / 4. Prints each process's device-input
    ms beside the IPC form's and the single process's, and the ms a hop by
    part (copy out, gloo, copy in, flag). Returns process 0's launches by
    kernel."""
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.ops.fused_rotation import TIMEOUT_S
    from mpi_knn_tpu_torch.parallel.hostlink import link_kind
    from mpi_knn_tpu_torch.shapes import ring_tiles

    t_phase = time.perf_counter()
    label, over = MP_HOSTS_FORM
    m, d = X.shape
    n_proc, P = len(hosts), MP_P
    ranks = P // n_proc
    tmp = tempfile.mkdtemp(prefix="tknn-mph-")
    try:
        env = {"MP_RANKS": str(ranks), "MP_HOSTS": ",".join(hosts)}
        if cards:
            env["NCCL_SOCKET_IFNAME"] = os.environ.get("NCCL_SOCKET_IFNAME", "lo")
        got = multiproc_pod(tmp, m, n_proc, env=env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    infos = [doc["info"] for doc, _, _ in got]
    per = [doc["hosts"][label] for doc, _, _ in got]
    si, sd, sms, scounts = k5["single"]
    ii, idist, ims, _ = k5["ipc"]
    equal_single = all(np.array_equal(a[f"hosts/{label}/ids"], si)
                       and np.array_equal(a[f"hosts/{label}/dists"], sd)
                       for _, a, _ in got)
    equal_ipc = all(np.array_equal(a[f"hosts/{label}/ids"], ii)
                    and np.array_equal(a[f"hosts/{label}/dists"], idist)
                    for _, a, _ in got)
    import torch

    rec = recall(torch.from_numpy(got[0][1][f"hosts/{label}/ids"]))
    c_pad = ring_tiles(KNNConfig(k=K, backend="ring-overlap", **over), m, m, 1, P)[3]
    b = c_pad // P
    hop = b * d * 4 + b * 4 + b * 4  # block (f32), ids, norms
    hops = P - 1
    kinds = [[link_kind(list(hosts), p, (p + 1) % n_proc),
              link_kind(list(hosts), p, (p - 1) % n_proc)] for p in range(n_proc)]
    parts = {}
    for f, k in zip(per, kinds):
        pr, moved = f["proxy"], max(1, (k[0] == "proxy") * hops)
        parts.setdefault("copy_out_ms_per_hop", []).append(
            1e3 * pr["copy_out_s"] / moved)
        parts.setdefault("gloo_ms_per_hop", []).append(1e3 * pr["gloo_s"] / hops)
        parts.setdefault("copy_in_ms_per_hop", []).append(
            1e3 * pr["copy_in_s"] / max(1, (k[1] == "proxy") * hops))
        parts.setdefault("flag_ms_per_hop", []).append(
            1e3 * pr["flag_s"] / max(1, (k[1] == "proxy") * hops))
        parts.setdefault("wait_ms_per_call", []).append(1e3 * pr["wait_s"])
    line = {"phase": "multiproc_cards_hosts_k5" if cards else "multiproc_hosts_k5",
            "path": label, "m": m, "k": K, "processes": n_proc,
            "ranks_a_process": ranks, "ring": P, "hosts": infos[0]["hosts"],
            "backend": infos[0]["backend"], "cards": [i["cards"] for i in infos],
            "link_kinds": [f["link_kinds"] for f in per],
            f"bit_equal_single_process_p{P}": equal_single,
            "bit_equal_ipc_form": equal_ipc, "recall_at_10": rec,
            "launches": [f["launches"] for f in per],
            f"single_process_p{P}_launches": scounts,
            "ipc_mappings": [f["ipc_mappings"] for f in per],
            "device_input_ms": [f["device_input_ms"] for f in per],
            "ipc_form_device_input_ms": ims,
            f"single_process_p{P}_device_input_ms": sms,
            "gather_ms": [f["gather_ms"] for f in per],
            "proxy": [f["proxy"] for f in per],
            "proxy_first_call": [f["proxy_first"] for f in per],
            "hop_bytes": hop, **parts, "wait_bound_s": TIMEOUT_S,
            "startup_seconds": [i["startup_seconds"] for i in infos],
            "worker_exit_seconds": [e for _, _, e in got],
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    name = f"{line['phase']} {n_proc}x{ranks}"
    if not (equal_single and equal_ipc):
        raise AssertionError(f"{name}: a process's result differs from the "
                             "single-process K5 ring or the IPC form")
    if rec < RECALL_GATE:
        raise AssertionError(f"{name}: recall@10 {rec}")
    if infos[0]["hosts"] != list(hosts) or line["link_kinds"] != kinds:
        raise AssertionError(f"{name}: hosts {infos[0]['hosts']} and links "
                             f"{line['link_kinds']}, expected {list(hosts)}, {kinds}")
    if not cards and infos[0]["backend"] != "gloo":
        raise AssertionError("processes sharing one card must take gloo, whatever "
                             f"hosts they report: {infos[0]}")
    for f, i, k in zip(per, infos, kinds):
        # one K5 launch a card a process; the rest the single process's share
        n_cards = len(set(i["cards"]))
        want = {n: n_cards if n == "fused_rotation_grid" else c * ranks // P
                for n, c in scounts.items()}
        if f["launches"] != want:
            raise AssertionError(f"{name}: launches {line['launches']}, expected "
                                 f"{want} a process")
        # an "ipc" link past the last rank maps the successor's flag words and
        # slots (2 allocations), one before the first its predecessor's words
        mappings = 2 * (k[0] == "ipc") + (k[1] == "ipc")
        if f["ipc_mappings"] != mappings:
            raise AssertionError(f"{name}: {f['ipc_mappings']} CUDA IPC mappings "
                                 f"for links {k}, expected {mappings}: a proxy "
                                 "link opens none")
        for pr in (f["proxy"], f["proxy_first"]):
            sent = hops if k[0] == "proxy" else 0
            got_hops = hops if k[1] == "proxy" else 0
            if not (pr["hops_sent"] == sent and pr["hops_received"] == got_hops
                    and pr["bytes_sent"] == sent * hop
                    and pr["bytes_received"] == got_hops * hop
                    and pr["block_bytes"] == sent * b * d * 4):
                raise AssertionError(f"{name}: the proxy moved {pr}, expected "
                                     f"{sent} hops out and {got_hops} in of {hop} "
                                     "bytes each")
    if max(line["device_input_ms"]) > 1e3 * TIMEOUT_S / 4:
        raise AssertionError(f"{name}: K5 across hosts took "
                             f"{line['device_input_ms']} ms: its waits come near "
                             f"their {TIMEOUT_S} s bound")
    return dict(per[0]["launches"])


def _multiproc_gates(got, single, recall, key, prefix, P, exchanges, dirs,
                     resumable_counts=None, phase="multiproc", ranks=1) -> dict:
    """The gates of one ring of the pod (``key`` in each worker's json,
    ``prefix`` of its arrays) against the single-process runs ``single``
    over the same P ranks; emits a line a form. Returns process 0's
    launches by kernel, summed over the forms."""
    import torch

    m = len(got[0][1][f"{prefix}{MP_RESUMABLE}/ids"])
    totals = {}
    for label in single:
        wi, wd, wcounts, wms = single[label]
        per = [doc[key][label] for doc, _, _ in got]
        equal = all(np.array_equal(a[f"{prefix}{label}/ids"], wi)
                    and np.array_equal(a[f"{prefix}{label}/dists"], wd)
                    for _, a, _ in got)
        rec = recall(torch.from_numpy(got[0][1][f"{prefix}{label}/ids"]))
        line = {"phase": phase, "path": label, "m": m, "k": K,
                "processes": MP_PROCESSES, "ranks_a_process": ranks, "ring": P,
                f"bit_equal_single_process_p{P}": equal, "recall_at_10": rec,
                "launches": [f["launches"] for f in per],
                f"single_process_p{P}_launches": wcounts,
                "finite": bool(np.isfinite(got[0][1][f"{prefix}{label}/dists"]).all())}
        if label == MP_RESUMABLE:
            want_stop, want = resumable_counts or (
                {"fused_round_dma": 1, "stage_tf32_split[ring]": 2},
                {"fused_block_merge[exact]": 1, "stage_tf32_split[ring]": 2})
            line.update(rounds_stopped=[f["rounds_stopped"] for f in per],
                        rounds_resumed=[f["rounds_resumed"] for f in per],
                        launches_stopped=[f["launches_stopped"] for f in per],
                        checkpoint_files=dirs)
            schedule_ok = (all(f["rounds_resumed"] == list(range(2, P + 1))
                               for f in per)
                           and dirs == [True] + [False] * (MP_PROCESSES - 1)
                           and all(f["launches_stopped"] == want_stop for f in per))
        else:
            b = per[0]["boundary"]
            rounds = max(1, b["exchanges"])
            line.update(device_input_ms=[f["device_input_ms"] for f in per],
                        **{f"single_process_p{P}_device_input_ms": wms},
                        gather_ms=[f["gather_ms"] for f in per],
                        boundary_exchanges=b["exchanges"],
                        boundary_bytes_per_exchange=b["bytes_sent"] / rounds,
                        boundary_ms_per_exchange=1e3 * b["seconds"] / rounds,
                        boundary_d2h_ms_per_exchange=1e3 * b["d2h_seconds"] / rounds,
                        boundary_h2d_ms_per_exchange=1e3 * b["h2d_seconds"] / rounds)
            schedule_ok = all(f["boundary"]["exchanges"] == exchanges[label]
                              for f in per)
            dp = label.startswith("dp")  # each process runs one dp group
            want = {n: c if n in MP_PER_CARD and not dp else c // MP_PROCESSES
                    for n, c in wcounts.items()}
        emit(line)
        if not equal:
            raise AssertionError(f"{phase} {label}: a process's result differs "
                                 f"from the single-process P={P} run")
        if rec < RECALL_GATE or not line["finite"]:
            raise AssertionError(f"{phase} {label}: recall@10 {rec} or non-finite")
        if not schedule_ok:
            raise AssertionError(f"{phase} {label}: the resume is not process 0's, "
                                 f"or the boundary moved other than "
                                 f"{exchanges.get(label)} times: {line}")
        if any(f["launches"] != want for f in per):
            raise AssertionError(f"{phase} {label}: launches {line['launches']}, "
                                 f"expected {want} a process")
        for n, c in per[0]["launches"].items():
            totals[n] = totals.get(n, 0) + c
        if label == MP_RESUMABLE:
            for n, c in per[0]["launches_stopped"].items():
                totals[n] = totals.get(n, 0) + c
    return totals


def multiproc_ranks_gates(got, single, recall, ranks, dirs) -> dict:
    """The pod of ``ranks`` ranks a process (2 × 2 on the one card: cuda:0
    named twice in each process): fused-dma (K4's in-kernel stores between
    a process's own ranks, the outbox at the boundary), bidir K3a,
    Tensor.to with the xla merge, the grid form (K5, one launch a process,
    the boundary over CUDA IPC: no block moved by the process group), the
    resumable fused-dma ring stopped after 1 round and resumed from
    process 0's checkpoint, and --dp 2 over the same ranks (each group
    inside one process). Gates: every form bit for bit the single-process
    P = processes × ranks ring on the one card (--dp: the single-process
    2-D mesh), recall@10 >= RECALL_GATE, each process's launches (K4 and
    K5 a card as the single process's, the per-rank kernels and every
    --dp kernel half), the boundary moves MP_RANK_EXCHANGES; K5's waits
    well inside their bound (its whole call a process under TIMEOUT_S / 4,
    so no one wait comes near it).
    Returns process 0's launches by kernel."""
    from mpi_knn_tpu_torch.ops.fused_rotation import TIMEOUT_S

    P = MP_PROCESSES * ranks
    totals = _multiproc_gates(
        got, single, recall, "ranks", "ranks/", P, MP_RANK_EXCHANGES, dirs,
        resumable_counts=(MP_RANK_RESUMABLE["stopped"], MP_RANK_RESUMABLE["resumed"]),
        phase="multiproc_ranks", ranks=ranks)
    k5 = [doc["ranks"]["fused-grid/K5"]["device_input_ms"] for doc, _, _ in got]
    emit({"phase": "multiproc_ranks_k5", "device_input_ms": k5,
          "single_process_ms": single["fused-grid/K5"][3],
          "wait_bound_s": TIMEOUT_S})
    if max(k5) > 1e3 * TIMEOUT_S / 4:
        raise AssertionError(f"K5 across processes took {k5} ms: its waits come "
                             f"near their {TIMEOUT_S} s bound")
    return totals


# ---- the sharded clustered store live across processes ------------------
# README.md's sharded deployment (sift:100000, 256 partitions, nprobe 2,
# --devices 4, 128-row mutation chunks) as SM_PROCESSES processes of
# SM_RANKS shards each on the one card, beside the one-process 4-shard
# store on the same card
SM_PROCESSES = 2
SM_RANKS = 2
SM_UPSERTS = 20  # 128-row upserts, every fourth an update of an earlier chunk
SM_DELETES = 20  # 128-row deletes of corpus ids, one after each upsert
# rows at one spot, past any bucket's free slots after the retrain's
# compaction: overflows, compacts, then grows the cap
SM_BURST = 4096
SM_CHECK = 32  # held-out queries searched after every step
SM_QUIET = 4  # 512-row session batches with no churn, then SM_BATCHES with it
SM_BATCHES = 16
SM_BATCH = IVF_BATCH
# the sessions' --route-cap: at the safe cap (256 routes a (home, owner)
# pair) a 512-row batch of the pod on one card stages ~2.5 GB a process
# through host memory (5.3-6.0 s a batch on one H100)
SM_ROUTE_CAP = 64
SM_DEADLINE_S = 60.0  # the session's deadline: decided once for the pod


def sm_ops(churn, plan) -> list:
    """The churn sequence from the saved pool: one upsert a pool chunk
    (every fourth the ids of the chunk three before with fresh rows:
    updates that move rows to other partitions), each of the first
    ``plan["deletes"]`` followed by a delete of a chunk of corpus ids; a
    compaction with retrain; the burst."""
    pool, burst = churn["pool"], churn["burst"]
    B, base = plan["chunk"], plan["id_base"]
    ops = []
    for j in range(len(pool) // B):
        first = j - 3 if j % 4 == 3 else j
        ops.append(("upsert", base + first * B + np.arange(B), pool[j * B:(j + 1) * B]))
        if j < plan["deletes"]:
            ops.append(("delete", np.arange(2 * B * j, 2 * B * (j + 1), 2), None))
    ops.append(("compact", None, None))
    ops.append(("burst", base + 10 * len(pool) + np.arange(len(burst)), burst))
    return ops


def sm_checksum(t) -> list:
    """Two int64 sums over a tensor's 32-bit words where it lies (plain,
    and weighted by odd positions): a change of any one word changes the
    second. Equal checksums after every step, and equal bytes at the end,
    hold the slices bit for bit without copying them to the host."""
    import torch

    w = t.contiguous().view(-1).view(torch.int32).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) * 2 + 1
    return [int(w.sum()), int((w * pos).sum())]


def sm_drive(device, mesh, out_dir, sync) -> tuple[dict, dict]:
    """The phase's work on one process: the saved index sharded over
    ``mesh`` (the pod's, or SHARDS ranks of one card), the churn of
    :func:`sm_ops` through a session (each step timed, the held slices'
    checksums and a search of SM_CHECK queries after it), then a fresh
    index served at SM_ROUTE_CAP by a session of SM_QUIET quiet batches and
    SM_BATCHES with a mutation between each. Returns (a JSON-able record,
    arrays)."""
    import torch

    from mpi_knn_tpu_torch.ivf import load_ivf_index, search_ivf_sharded, shard_ivf_index
    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy
    from mpi_knn_tpu_torch.serve import ServeSession

    idx = load_ivf_index(os.path.join(out_dir, "index.npz"), device=device)
    Q = np.load(os.path.join(out_dir, "queries.npy"))
    churn = np.load(os.path.join(out_dir, "churn.npz"))
    with open(os.path.join(out_dir, "plan.json")) as f:
        plan = json.load(f)
    pod = distributed.pod() is not None
    rec, arrays = {"steps": [], "checksums": []}, {}
    reset_counts()
    sidx = shard_ivf_index(idx, mesh=mesh)
    sess = ServeSession(sidx, device=device)
    for n, (kind, ids, rows) in enumerate(sm_ops(churn, plan)):
        if pod:
            distributed.reset_collective_stats()
        sync()
        t0 = time.perf_counter()
        if kind in ("upsert", "burst"):
            sess.upsert(ids, rows)
        elif kind == "delete":
            sess.delete(ids)
        else:
            sess.compact(retrain=True)
        sync()
        step = {"kind": kind, "ms": 1e3 * (time.perf_counter() - t0),
                "cap": sidx.bucket_cap,
                **({k_: v for k_, v in distributed.COLLECTIVES.items()} if pod else {})}
        rec["steps"].append(step)
        rec["checksums"].append({
            str(s): [sm_checksum(t) for t in sl if t is not None]
            for s, sl in sidx.held()} | {"centroids": sm_checksum(sidx.centroids)})
        d, i, _ = search_ivf_sharded(sidx, Q[:plan["check"]], device=device)
        arrays[f"step{n}/d"], arrays[f"step{n}/i"] = d.cpu().numpy(), i.cpu().numpy()
    for s, sl in sidx.held():
        for k_, t in enumerate(sl):
            if t is not None:
                arrays[f"final/{s}/{k_}"] = t.cpu().numpy()
    rec["compactions"] = sess.stats_snapshot()["mutation"]["compactions"]
    del sess, sidx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the session: quiet batches, then batches with churn between them
    sidx = shard_ivf_index(idx, mesh=mesh)
    over = {} if plan["route_cap"] is None else {"ivf_route_cap": plan["route_cap"]}
    sess = ServeSession(sidx, device=device, resilience=ResiliencePolicy(
        batch_deadline_s=plan["deadline_s"]), **over)
    rows, B = plan["batch"], plan["chunk"]
    sess.warm([rows])
    pool = churn["pool"]
    done = {}
    for label, batches in (("quiet", plan["quiet"]), ("churn", plan["batches"])):
        got = []
        sync()
        t0 = time.perf_counter()
        for b in range(batches):
            got += sess.submit(Q[b * rows:(b + 1) * rows])
            if label == "churn":
                if b % 2 == 0:
                    c = b % (len(pool) // B)
                    sess.upsert(plan["id_base"] + 20 * len(pool) + b * B + np.arange(B),
                                pool[c * B:(c + 1) * B])
                else:
                    sess.delete(np.arange(b * B, (b + 1) * B))
        got += sess.drain()
        sync()
        wall = time.perf_counter() - t0
        done[label] = {"qps": batches * rows / wall, "wall_s": wall,
                       "seqs": [r.seq for r in got],
                       "rungs": [r.degraded or "full" for r in got],
                       "breaches": sum(r.deadline_breached for r in got),
                       "routed": sum(int(r.exchange[:, 0].sum()) for r in got),
                       "dropped": sum(int(r.exchange[:, 1].sum()) for r in got)}
        arrays[f"session/{label}/d"] = np.stack([r.dists for r in got])
        arrays[f"session/{label}/i"] = np.stack([r.ids for r in got])
    rec["session"] = done
    rec["launches"] = {n: c for n, c in read_counts().items() if c}
    return rec, arrays


def sharded_mutation_worker() -> int:
    """One process of the sharded_mutation phase's pod (``python
    chip_smoke.py --sharded-mutation-worker``): joins the process group
    from the launch environment with ``MP_RANKS`` shards (default
    SM_RANKS) and runs :func:`sm_drive` on the saved index in ``MP_DIR``
    over the pod's mesh; writes ``worker-<id>.json`` and ``.npz`` there."""
    import torch

    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    out_dir = os.environ["MP_DIR"]
    ranks = int(os.environ.get("MP_RANKS", str(SM_RANKS)))
    info = distributed.init_multihost(timeout_seconds=120,
                                      device=os.environ.get("MP_DEVICE", "cuda"),
                                      local_devices=ranks)
    pod = distributed.pod()

    def sync():
        for c in dict.fromkeys(pod.cards):
            if c.type == "cuda":
                torch.cuda.synchronize(c)

    try:
        rec, arrays = sm_drive(pod.card, make_ring_mesh(ranks, device=pod.card),
                               out_dir, sync)
    finally:
        distributed.shutdown()
    rec["info"] = info
    pid = info["process_id"]
    with open(os.path.join(out_dir, f"worker-{pid}.json"), "w") as f:
        json.dump(rec, f)
    np.savez(os.path.join(out_dir, f"worker-{pid}.npz"), **arrays)
    print(f"sharded-mutation worker {pid} done", flush=True)
    return 0


def sm_prepare(device, out_dir):
    """The deployment's index (256 partitions, headroom 0.5, 128-row
    mutation chunks) built on ``device`` and saved with the held-out
    queries and the churn's rows into ``out_dir``."""
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.ivf import build_ivf_index, save_ivf_index

    X, Q = ivf_data()
    idx = build_ivf_index(X, KNNConfig(k=K, partitions=IVF_P, bucket_headroom=0.5,
                                       mutation_bucket=MUT_BUCKET), device=device)
    save_ivf_index(idx, os.path.join(out_dir, "index.npz"))
    np.save(os.path.join(out_dir, "queries.npy"), Q)
    pool = mutation_pool()[:SM_UPSERTS * MUT_BUCKET]
    rng = np.random.default_rng(20)
    burst = (pool[:1] + 0.01 * rng.standard_normal((SM_BURST, pool.shape[1]))
             ).astype(np.float32)
    np.savez(os.path.join(out_dir, "churn.npz"), pool=pool, burst=burst)
    with open(os.path.join(out_dir, "plan.json"), "w") as f:
        json.dump({"chunk": MUT_BUCKET, "id_base": MUT_ID_BASE, "deletes": SM_DELETES,
                   "check": SM_CHECK, "batch": SM_BATCH, "quiet": SM_QUIET,
                   "batches": SM_BATCHES,
                   "route_cap": SM_ROUTE_CAP, "deadline_s": SM_DEADLINE_S}, f)
    return idx


def sm_gates(label, single, got, shards) -> None:
    """Every pod process's steps against the one-process store: each
    shard's checksums and the centroids' after every step, every step's
    search, the final slices' bytes, both sessions' results, and the rung
    of every seq on every process; no kernel launched."""
    srec, sarr = single
    for n in range(len(srec["steps"])):
        for pid, (rec, arr, _) in enumerate(got):
            mine = rec["checksums"][n]
            for key, sums in mine.items():
                if sums != srec["checksums"][n][key]:
                    raise AssertionError(f"{label} step {n} ({srec['steps'][n]['kind']}): "
                                         f"process {pid}'s {key} differs")
            for part in ("d", "i"):
                if not np.array_equal(arr[f"step{n}/{part}"], sarr[f"step{n}/{part}"]):
                    raise AssertionError(f"{label} step {n}: process {pid}'s search differs")
    held = set()
    for pid, (rec, arr, _) in enumerate(got):
        for key in arr:
            if key.startswith("final/"):
                held.add(key.split("/")[1])
                if not np.array_equal(arr[key], sarr[key]):
                    raise AssertionError(f"{label}: process {pid}'s {key} differs")
        for part in ("quiet/d", "quiet/i", "churn/d", "churn/i"):
            if not np.array_equal(arr[f"session/{part}"], sarr[f"session/{part}"]):
                raise AssertionError(f"{label}: process {pid}'s session {part} differs")
        if rec["launches"]:
            raise AssertionError(f"{label}: kernels launched: {rec['launches']}")
    if held != {str(s) for s in range(shards)}:
        raise AssertionError(f"{label}: the final slices held {sorted(held)}")
    for lab in ("quiet", "churn"):
        rungs = [rec["session"][lab]["rungs"] for rec, _, _ in got]
        seqs = [rec["session"][lab]["seqs"] for rec, _, _ in got]
        if any(r != rungs[0] for r in rungs) or any(s != seqs[0] for s in seqs):
            raise AssertionError(f"{label}: the processes' rungs or seqs differ")


def sm_summary(label, single, got, startup=None) -> dict:
    """The phase's printed line: per kind of step the median ms of the pod
    (process 0) and of one process, compaction seconds, the bytes of the
    agreements and of the compactions' row moves, the sessions' q/s."""
    def med(rec, kind):
        ms = [s["ms"] for s in rec["steps"] if s["kind"] == kind]
        return statistics.median(ms) if ms else None

    srec = single[0]
    pods = [rec for rec, _, _ in got]
    steps0 = pods[0]["steps"]
    return {
        "phase": label, "processes": len(got),
        "upsert_ms_a_chunk": [med(r, "upsert") for r in pods],
        "upsert_ms_a_chunk_one_process": med(srec, "upsert"),
        "delete_ms_a_chunk": [med(r, "delete") for r in pods],
        "delete_ms_a_chunk_one_process": med(srec, "delete"),
        "compaction_s": [[s["ms"] / 1e3 for s in r["steps"] if s["kind"] == "compact"]
                         for r in pods],
        "compaction_s_one_process": [s["ms"] / 1e3 for s in srec["steps"]
                                     if s["kind"] == "compact"],
        "burst_s": [[s["ms"] / 1e3 for s in r["steps"] if s["kind"] == "burst"]
                    for r in pods],
        "burst_s_one_process": [s["ms"] / 1e3 for s in srec["steps"] if s["kind"] == "burst"],
        "caps": sorted({s["cap"] for s in steps0}),
        "compactions": [r["compactions"] for r in pods],
        # across processes: the plans' agreement (a digest gathered from
        # every process) and the compactions' rows (the retrain sample's
        # share to process 0, the live rows to their new shard's process)
        "agreement_bytes_a_mutation": statistics.median(
            [s.get("agreement_bytes", 0) for s in steps0
             if s["kind"] in ("upsert", "delete")]),
        "compaction_agreement_bytes": [s.get("agreement_bytes", 0) for s in steps0
                                       if s["kind"] in ("compact", "burst")],
        "compaction_row_bytes_sent": [[s.get("row_bytes_sent", 0) for s in r["steps"]
                                       if s["kind"] in ("compact", "burst")] for r in pods],
        "compaction_row_seconds": [[s.get("row_seconds", 0.0) for s in r["steps"]
                                    if s["kind"] in ("compact", "burst")] for r in pods],
        "session_qps": {lab: [r["session"][lab]["qps"] for r in pods]
                        for lab in ("quiet", "churn")},
        "session_qps_one_process": {lab: srec["session"][lab]["qps"]
                                    for lab in ("quiet", "churn")},
        "session_breaches": [r["session"]["churn"]["breaches"] for r in pods],
        "session_route_cap": SM_ROUTE_CAP,
        "session_routed_dropped": [[r["session"][lab][k_] for lab in ("quiet", "churn")
                                    for k_ in ("routed", "dropped")] for r in pods],
        "launches": [r["launches"] for r in pods],
        "launches_one_process": srec["launches"],
        **({"startup": startup} if startup else {}),
    }


def sharded_mutation_phase(device) -> None:
    """README.md's sharded deployment live across processes on the one
    card: the one-process 4-shard store (a mesh naming the card SHARDS
    times) and a pod of SM_PROCESSES processes × SM_RANKS shards (gloo,
    the rows staged through host memory) take the same churn and the same
    sessions; :func:`sm_gates` holds every process to the one-process
    store bit for bit after every step."""
    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tknn-sm-")
    try:
        idx = sm_prepare(device, tmp)
        del idx
        single = sm_drive(device, [device] * SHARDS, tmp, sync_all)
        torch.cuda.empty_cache()
        t_pod = time.perf_counter()
        got = multiproc_pod(tmp, IVF_M, SM_PROCESSES, env={"MP_RANKS": str(SM_RANKS)},
                            worker="--sharded-mutation-worker")
        pod_s = time.perf_counter() - t_pod
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    infos = [rec["info"] for rec, _, _ in got]
    line = sm_summary("sharded_mutation", single, got, {
        "backend": infos[0]["backend"], "cards": [i["cards"] for i in infos],
        "startup_seconds": [i["startup_seconds"] for i in infos],
        "worker_exit_seconds": [e for _, _, e in got], "pod_seconds": pod_s})
    emit(line)
    sm_gates("sharded_mutation", single, got, SHARDS)
    if len(line["caps"]) < 2 or min(line["compactions"]) < 2:
        raise AssertionError(f"sharded_mutation: the burst did not compact and grow: "
                             f"caps {line['caps']}, compactions {line['compactions']}")
    if single[0]["launches"]:
        raise AssertionError(f"sharded_mutation: kernels launched: {single[0]['launches']}")
    emit({"phase": "sharded_mutation_done", "seconds": time.perf_counter() - t_phase})


def sharded_mutation_cards(cards) -> None:
    """The sharded_mutation phase over four cards, each against the
    one-process store on ``cards[0]`` named SHARDS times: one process with
    its SHARDS slices on four distinct cards (the chunk's entries and a
    compaction's rows move between cards by ``Tensor.to``), and two
    processes of two cards each (NCCL between the processes through each
    one's first card). :func:`sm_gates` for both."""
    import torch

    tmp = tempfile.mkdtemp(prefix="tknn-smc-")
    try:
        sm_prepare(cards[0], tmp)
        single = sm_drive(cards[0], [cards[0]] * SHARDS, tmp, sync_all)
        torch.cuda.empty_cache()
        spread = sm_drive(cards[0], list(cards[:SHARDS]), tmp, sync_all)
        torch.cuda.empty_cache()
        t_pod = time.perf_counter()
        got = multiproc_pod(tmp, IVF_M, SM_PROCESSES, worker="--sharded-mutation-worker",
                            env={"MP_RANKS": str(SM_RANKS), "NCCL_SOCKET_IFNAME":
                                 os.environ.get("NCCL_SOCKET_IFNAME", "lo")})
        pod_s = time.perf_counter() - t_pod
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one = [(*spread, 0.0)]
    emit(sm_summary("sharded_mutation_cards/one_process_four_cards", single, one))
    sm_gates("sharded_mutation_cards/one_process_four_cards", single, one, SHARDS)
    infos = [rec["info"] for rec, _, _ in got]
    emit(sm_summary("sharded_mutation_cards/two_processes_two_cards", single, got, {
        "backend": infos[0]["backend"], "cards": [i["cards"] for i in infos],
        "startup_seconds": [i["startup_seconds"] for i in infos], "pod_seconds": pod_s}))
    if infos[0]["backend"] != "nccl+gloo":
        raise AssertionError(f"processes on cards of their own must take NCCL: {infos[0]}")
    sm_gates("sharded_mutation_cards/two_processes_two_cards", single, got, SHARDS)


LINT_TIMEOUT_S = 600  # the lint children's limit: the 79 cells on the card
# the matrix split by backend over children that run side by side (each
# its own process: the allocator's peak R7 reads is a process's)
LINT_PARTS = (("--backend", "serial", "--backend", "pallas"),
              ("--backend", "ring"),
              ("--backend", "ring-overlap", "--fusion", "xla"),
              ("--backend", "ring-overlap", "--fusion", "fused"),
              ("--backend", "ivf", "--backend", "ivf-sharded"))
# the cells the port's own entry refuses, as the JAX package's lint skips
# them: the fused backend computes in float32 only
LINT_SKIPS = {"pallas/l2/bfloat16", "pallas/l2/float64",
              "pallas/cosine/bfloat16", "pallas/cosine/float64"}
# the matrix has no cell at the main path's other settings: four of its
# cells run again at them (``lowering.VARIANT_FIELDS``), so the lint also
# reaches K2, K2[c], K5 and the bin minimum
LINT_VARIANTS = (("pallas/l2/float32", {"pallas_variant": "sweep"}),
                 ("pallas/l2/float32/mixed", {"pallas_variant": "sweep"}),
                 ("ring-overlap/l2/float32/fused", {"ring_fused_rotation": "grid"}),
                 ("serial/l2/float32", {"topk_method": "approx"}))
# the kernels the cells and the variants launch on the card
LINT_KERNELS = ("fused_knn_tiles", "fused_knn_sweep", "fused_knn_tiles[compress]",
                "fused_knn_sweep[compress]", "fused_block_merge[exact]",
                "fused_block_merge[compress]", "fused_round_dma",
                "fused_rotation_grid", "approx_min_k", "stage_tf32_split",
                "stage_bf16", "stage_tf32[wire]", "stage_bf16[wire]",
                "stage_tf32_split[ring]")


def lint_scheme(t: dict) -> str:
    """The scheme a cell of the lint report belongs to."""
    if t["mutate"]:
        return "mutate"
    if t["backend"] in ("ivf", "ivf-sharded"):
        return t["backend"]
    if t["fusion"] == "fused":
        return "fused"
    if t["backend"] in ("ring", "ring-overlap"):
        return f"ring {t['schedule']}"
    return f"dense {t['policy']}"


def lint_phase() -> dict:
    """``lint --device cuda --memory --cost`` over the whole matrix, in
    children of this checkout (``LINT_PARTS``), then ``LINT_VARIANTS`` in
    this process: every cell 0 findings (R8's counted FLOPs, the kernels'
    side-band ones among them, equal to the closed form; R7's trace peak
    inside ``ALLOCATOR_BAND`` of the allocator's growth), the named
    refusals only. Returns the launches the side-band records counted, a
    kernel each."""
    t0 = time.perf_counter()
    reports, rcs = [], []
    with tempfile.TemporaryDirectory(prefix="tknn-lint-") as out:
        procs, ended, errs = [], {}, []
        for i, part in enumerate(LINT_PARTS):
            errs.append(open(os.path.join(out, f"{i}.err"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mpi_knn_tpu_torch", "lint", "--device",
                 "cuda", "--memory", "--cost", "-q", "--out",
                 os.path.join(out, str(i)), *part],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.DEVNULL, stderr=errs[-1]))
        try:
            # each child's seconds: poll until every one has ended
            while len(ended) < len(procs):
                if time.perf_counter() - t0 > LINT_TIMEOUT_S:
                    raise AssertionError(f"lint: children past {LINT_TIMEOUT_S} s")
                for i, proc in enumerate(procs):
                    if i not in ended and proc.poll() is not None:
                        ended[i] = time.perf_counter() - t0
                time.sleep(0.1)
            for i, proc in enumerate(procs):
                errs[i].seek(0)
                err = errs[i].read()
                rcs.append(proc.returncode)
                path = os.path.join(out, str(i), "report.json")
                if not os.path.exists(path):
                    raise AssertionError(f"lint {LINT_PARTS[i]}: exit "
                                         f"{proc.returncode}, no report:\n"
                                         f"{err[-3000:]}")
                reports.append(json.loads(open(path).read()))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in errs:
                f.close()
    children_s = time.perf_counter() - t0
    report = {"platform": {r["platform"] for r in reports},
              "device_name": reports[0]["device_name"]}
    targets = [t for r in reports for t in r["targets"]]
    # the variants, in this process (its kernels are built)
    from mpi_knn_tpu_torch.analysis import engine, lowering

    cells = {t.label: t for t in lowering.default_targets()}
    variants = [engine.lint_target(cells[label], device="cuda", overrides=ov)
                for label, ov in LINT_VARIANTS]
    for v in variants:
        emit({"phase": "lint_variant", "label": v.target.label,
              "overrides": v.overrides, "findings": len(v.findings),
              "launches": v.launches, "counted_flops": v.cost["mxu_flops"],
              "kernel_flops": v.cost["kernel_flops"],
              "analytical_flops": v.cost["analytical_flops"],
              "trace_peak_alloc": v.memory["peak_alloc_bytes"],
              "allocator_growth": v.memory["measured_bytes"]})
    seconds = time.perf_counter() - t0
    skipped = {t["label"] for t in targets if t["skipped"] is not None}
    findings = [(t["label"], f["rule"], f["message"]) for t in targets
                for f in t["findings"]] + [
        (v.target.label, f.rule, f.message) for v in variants for f in v.findings]
    launches, schemes = {}, {}
    for t in targets + [v.to_json() for v in variants]:
        for name, n in t["launches"].items():
            launches[name] = launches.get(name, 0) + n
        if t["skipped"] is not None:
            continue
        c, m = t["cost"], t["memory"]
        s = schemes.setdefault(lint_scheme(t), {
            "cells": 0, "kernel_flops": 0, "counted_flops": 0,
            "analytical_flops": 0, "flops_equal": True, "trace_peak_alloc": [],
            "allocator_growth": []})
        s["cells"] += 1
        s["kernel_flops"] += c["kernel_flops"]
        s["counted_flops"] += c["mxu_flops"]
        s["analytical_flops"] += c["analytical_flops"]
        s["flops_equal"] &= c["mxu_flops"] == c["analytical_flops"]
        s["trace_peak_alloc"].append(m["peak_alloc_bytes"])
        s["allocator_growth"].append(m["measured_bytes"])
    for name, s in schemes.items():
        peaks, growth = s.pop("trace_peak_alloc"), s.pop("allocator_growth")
        emit({"phase": "lint_scheme", "scheme": name, **s,
              "trace_peak_alloc_max": max(peaks),
              "allocator_growth_max": max(growth),
              "growth_minus_peak": [min(g - p for g, p in zip(growth, peaks)),
                                    max(g - p for g, p in zip(growth, peaks))]})
    out = {"phase": "lint", "rcs": rcs, "seconds": seconds,
           "children_seconds": children_s,
           "children": [{"args": " ".join(p), "seconds": ended[i],
                         "cells": len(r["targets"])}
                        for i, (p, r) in enumerate(zip(LINT_PARTS, reports))],
           "platform": sorted(report["platform"]),
           "device_name": report["device_name"], "cells": len(targets),
           "skipped": sorted(skipped), "findings": findings[:20],
           "launches": launches}
    emit(out)
    missing = [n for n in LINT_KERNELS if not launches.get(n)]
    if (any(rcs) or findings or skipped != LINT_SKIPS
            or any(v.skipped for v in variants)
            or len({t["label"] for t in targets}) != 79
            or report["platform"] != {"cuda"}
            or missing or not all(s["flops_equal"] for s in schemes.values())):
        raise AssertionError(f"lint: {out}, kernels not launched: {missing}")
    return launches


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
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        mma = dict(zip(_build.SOURCES, pool.map(
            lambda src: sass_mma_counts(_build._lib_path(src)), _build.SOURCES)))
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
    recall = f64_recall(X)  # the reference's workload, on the input data
    sample256 = recall.sample
    # what the int8 wire hands the rerank: each row's dequantized codes
    want_wire = f64_oracle(dequantize_rows(*quantize_rows(Xcd)).cpu().numpy(),
                           sample256, queries=Xc, rtol=1e-6)

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
    # ---- live mutation at the README's mutable deployment -----------------
    mutate_phase(device)
    mark("mutate")
    # ---- the serving session's operations layer --------------------------
    fe_tmp = tempfile.mkdtemp(prefix="tknn-fe-cache-")
    try:
        fe_cache = os.path.join(fe_tmp, "kc")
        ops_phase(device, X, inputs, keep_cache=fe_cache)
        mark("ops")
        # ---- the serving front end, its load generator and router ----------
        fe_counts = frontend_phase(device, X, inputs, fe_cache)
    finally:
        shutil.rmtree(fe_tmp, ignore_errors=True)
    mark("frontend")
    # ---- the profile surface: every window's trace against the counters --
    profile_launches = {}
    for counts in profile_phase(device, X, inputs).values():
        for n, c in counts.items():
            profile_launches[n] = profile_launches.get(n, 0) + c
    mark("profile")
    # ---- the sharded clustered index at the README's deployment ----------
    sharded_phase(device)
    mark("ivf_sharded")
    # ---- the 2-D dp x ring mesh on the one card ---------------------------
    mesh2d_launches = mesh2d_phase(device, X, recall)
    mark("mesh2d")
    # ---- more than one process: the ring through a pod on the one card ---
    multiproc_launches, multiproc_ranks_launches, k5_refs = multiproc_phase(
        device, X, recall, ranks=MP_RANKS)
    mark("multiproc")
    # ---- K5 across hosts: the pod told apart into two hosts ---------------
    multiproc_hosts_launches = multiproc_hosts_phase(X, recall, k5_refs)
    mark("multiproc_hosts")
    # ---- the sharded clustered store live across processes ---------------
    sharded_mutation_phase(device)
    mark("sharded_mutation")
    # ---- the lint: rules R1-R8 over every cell of the matrix, recorded ----
    lint_launches = lint_phase()
    mark("lint")
    frontend_launches = {n: fe_counts["a"].get(n, 0) + fe_counts["b"].get(n, 0)
                         for n in ("fused_knn_tiles", "stage_tf32_split",
                                   "fused_knn_tiles[compress]", "stage_bf16")}
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
         "bound_by": times[name]["bound_by"], "library_ms": library_of[name],
         # the launches of the front end's phase (counts set to 0 before it)
         **({"frontend_launches": frontend_launches[name]}
            if name in frontend_launches else {}),
         # the profiled windows' launches (each equal to its trace's) and
         # the 2-D mesh phase's
         **({"profile_launches": profile_launches[name]}
            if name in profile_launches else {}),
         **({"mesh2d_launches": mesh2d_launches[name]}
            if name in mesh2d_launches else {}),
         # the multiproc phase's process 0 (each process's equal)
         **({"multiproc_launches": multiproc_launches[name]}
            if name in multiproc_launches else {}),
         # the pod of MP_RANKS ranks a process (process 0's; each equal)
         **({"multiproc_ranks_launches": multiproc_ranks_launches[name]}
            if name in multiproc_ranks_launches else {}),
         # the same pod told apart into two hosts: K5 over the host proxy
         **({"multiproc_hosts_launches": multiproc_hosts_launches[name]}
            if name in multiproc_hosts_launches else {}),
         # the lint phase's cells (its side-band records, one a launch)
         **({"lint_launches": lint_launches[name]}
            if name in lint_launches else {})}
        for name in replaces
    ]})
    mark("kernels_line")
    emit({"phase": "total_seconds", "seconds": marks[-1][1] - marks[0][1]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


def multiproc_cards_main() -> int:
    """``python3 chip_smoke.py --multiproc-cards``, on a host with four
    cards: the main shape through the multiproc pod of two processes × two
    cards (cards {0, 1} and {2, 3}: NCCL between the processes through each
    one's first card, K4's peer stores inside each, K5 across the processes
    over CUDA IPC between cards). Prints, per form, each process's
    device-input ms beside the single-process run over the same cards
    (P = 4 on cards 0-3, the 2×2 mesh for --dp 2, P = 2 on cards {0, 2}
    for the one-rank ring) and the boundary's exchanges, bytes, ms and
    bytes staged between a process's cards; fails unless every result is
    bit for bit the single-process run's. Then the same pod told apart
    into two hosts (:func:`multiproc_hosts_phase`: K5 over the host proxy
    at both boundaries, gated as on the one card, the backend nccl+gloo),
    and the sharded clustered store live over the four cards
    (:func:`sharded_mutation_cards`)."""
    import torch

    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --multiproc-cards: needs four CUDA cards", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    _build.build_all()
    cards = [torch.device("cuda", c) for c in range(4)]
    X, _ = make_mnist_like(M_FULL)
    Xd = torch.from_numpy(X).to(cards[0])
    single = {("forms", lab): v for lab, v in _single_forms(
        cards[0], Xd, [cards[0], cards[2]], MP_FORMS).items()}
    single.update({("ranks", lab): v for lab, v in _single_forms(
        cards[0], Xd, cards, MP_RANK_FORMS).items()})
    single.update({("ranks", lab): v for lab, v in _single_forms(
        cards[0], Xd, make_mesh2d(MP_DP, 2, devices=cards), MP_DP_FORMS).items()})
    del Xd
    tmp = tempfile.mkdtemp(prefix="tknn-mpc-")
    try:
        got = multiproc_pod(tmp, M_FULL, MP_PROCESSES, env={
            "MP_RANKS": "2",
            "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "multiproc_cards_startup", "infos": [doc["info"] for doc, _, _ in got]})
    for (key, label), (wi, wd, wcounts, wms) in single.items():
        prefix = "ranks/" if key == "ranks" else ""
        per = [doc[key][label] for doc, _, _ in got]
        equal = all(np.array_equal(a[f"{prefix}{label}/ids"], wi)
                    and np.array_equal(a[f"{prefix}{label}/dists"], wd)
                    for _, a, _ in got)
        b = per[0]["boundary"]
        n = max(1, b["exchanges"])
        emit({"phase": "multiproc_cards", "ring": 2 if key == "forms" else 4,
              "path": label, "bit_equal_single_process": equal,
              "device_input_ms": [f["device_input_ms"] for f in per],
              "single_process_device_input_ms": wms,
              "gather_ms": [f["gather_ms"] for f in per],
              "boundary_exchanges": b["exchanges"],
              "boundary_bytes_per_exchange": b["bytes_sent"] / n,
              "boundary_ms_per_exchange": 1e3 * b["seconds"] / n,
              "boundary_hop_bytes": b["hop_bytes"],
              "launches": [f["launches"] for f in per],
              "single_process_launches": wcounts})
        if not equal:
            raise AssertionError(f"multiproc_cards {label}: a process's result "
                                 "differs from the single-process run")
    # K5 across hosts on the four cards: the same 2 x 2 pod told apart into
    # two hosts, then 4 x 1 on two hosts (an "ipc" and a proxy link each);
    # backend nccl+gloo: no NCCL call may run during K5
    label = MP_HOSTS_FORM[0]
    wi, wd, wcounts, wms = single[("ranks", label)]
    k5 = {"single": (wi, wd, wms, wcounts),
          "ipc": (got[0][1][f"ranks/{label}/ids"],
                  got[0][1][f"ranks/{label}/dists"],
                  [doc["ranks"][label]["device_input_ms"] for doc, _, _ in got],
                  got[0][0]["ranks"][label]["launches"])}
    recall = f64_recall(X)
    multiproc_hosts_phase(X, recall, k5, cards=cards)
    multiproc_hosts_phase(X, recall, k5, cards=cards, hosts=MP_HOSTS_MIXED)
    # the sharded clustered store live over the four cards
    sharded_mutation_cards(cards)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--multiproc-worker"]:
        sys.exit(multiproc_worker())
    if sys.argv[1:] == ["--sharded-mutation-worker"]:
        sys.exit(sharded_mutation_worker())
    if sys.argv[1:] == ["--multiproc-cards"]:
        sys.exit(multiproc_cards_main())
    sys.exit(main())

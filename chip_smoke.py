#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mpi_knn_tpu_torch).

    python3 chip_smoke.py        # needs one CUDA card; builds csrc/ with nvcc

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel source compiles with nvcc;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   same card inputs — small-integer data (every product exact in f32: ids
   and distances must be equal), MNIST-shaped 8192x784 all-pairs, a
   query-mode case with a ragged corpus and the main path's 60000x784
   shape. Every id must be -1 exactly on non-finite slots, else inside its
   list's corpus range, below m_corpus and (all pairs) not the row itself.
   Off the small-integer cases, distances lie within rtol 1e-5 +
   1e-4*(q^2+c^2) of the plain version's and of the f64 distance of the id
   beside them, and ids agree at >= 0.999, an id the plain version did not
   pick counting when its own f64 distance ties the plain k-th. Each
   kernel and its plain version are timed by CUDA events at the main
   path's shapes, and the serial backend (torch.matmul + stable sort) on
   the same card inputs as the library yardstick;
4. main path: KNNClassifier(k=10, backend="pallas").fit(60000x784).
   loo_report() for both kernel variants, with launch counts reset just
   before and read just after; then the median of 3 synchronised all-kNN
   reps (warm-up excluded); recall@10 against an f64 host oracle on 256
   rows (>= 0.999 or fail); the same for the serial backend;
5. kernels: one line with every kernel's launches, error, times and bound
   (the FP32 FLOPs of 60000 real queries against 60000 real rows).

The last line is {"ok": true, "device": {...}}. Without a card, or without
the package beside it, the script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet: FP32 (non-tensor) peak and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
RECALL_GATE = 0.999
AGREEMENT_GATE = 0.999
K = 10
M_FULL = 60000
Q_TILE, C_TILE = 512, 2048  # the fused backend's clamps at the main path


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def true_sq_dists(q, c, ids):
    """f64 ||q_r - c_id||^2 for every (row r, id) of ``ids`` (Q, L), computed
    from the inputs alone (inf where id < 0), in row chunks of ~2^26 values."""
    import torch

    out = torch.full(ids.shape, float("inf"), dtype=torch.float64,
                     device=ids.device)
    rows = max(1, (1 << 26) // (ids.shape[1] * q.shape[1]))
    for r0 in range(0, ids.shape[0], rows):
        idc = ids[r0:r0 + rows]
        diff = q[r0:r0 + rows, None, :].double() - c[idc.clamp_min(0).long()].double()
        d = (diff * diff).sum(-1)
        out[r0:r0 + rows] = torch.where(idc >= 0, d, out[r0:r0 + rows])
    return out


def check_ids(name, gd, gi, m, all_pairs, k, span):
    """Ids the kernel wrote, judged on their own: −1 exactly on non-finite
    slots; else below m_corpus, inside the slot's own corpus range (list l
    of a row covers [l·span, (l+1)·span)), not the row itself in all-pairs
    mode, and no id twice in one list."""
    import torch

    Q, L = gi.shape
    fin = torch.isfinite(gd)
    if not torch.equal(gi < 0, ~fin) or bool((gi < -1).any()):
        raise AssertionError(f"{name}: id -1 must mark exactly the non-finite slots")
    lo = (torch.arange(L, device=gi.device) // k * span)[None, :]
    row = torch.arange(Q, device=gi.device)[:, None]
    bad = fin & ((gi >= m) | (gi < lo) | (gi >= lo + span))
    if all_pairs:
        bad |= fin & (gi == row)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} ids out of range or self")
    s = gi.reshape(Q, L // k, k).sort(-1).values
    if bool(((s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)).any()):
        raise AssertionError(f"{name}: an id appears twice in one list")


def compare(name, got, want, q, c, m, all_pairs, exact: bool, k: int,
            span: int) -> float:
    """Hold a kernel's (dists, ids) against its plain version's; returns the
    largest absolute distance difference over finite slots. Each sorted
    list of k is compared on its own (the tiles kernel emits one per query
    and corpus tile of ``span`` columns)."""
    import torch

    (gd, gi), (wd, wi) = got, want
    if gd.shape != wd.shape or gi.shape != wi.shape:
        raise AssertionError(f"{name}: shape {tuple(gd.shape)} != {tuple(wd.shape)}")
    check_ids(name, gd, gi, m, all_pairs, k, span)
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
    # every id is judged by its own f64 distance from the inputs, never by
    # the distance the kernel reported beside it
    q_sq = (q.double() ** 2).sum(1)
    c_sq = (c.double() ** 2).sum(1)
    true_g = true_sq_dists(q, c, gi)
    lists = gd.shape[1] // k
    shape = (-1, k)
    gd, gi, wd, wi, true_g = (t.reshape(shape) for t in (gd, gi, wd, wi, true_g))
    q_sq = q_sq.repeat_interleave(lists)[:, None]

    def tol(d, ids):
        return 1e-5 * d.abs() + 1e-4 * (q_sq + c_sq[ids.clamp_min(0).long()])

    if not bool(torch.where(fin.reshape(shape), diff.reshape(shape) <= tol(wd, wi),
                            True).all()):
        raise AssertionError(f"{name}: distances outside tolerance of the plain version")
    gfin = torch.isfinite(gd)
    if not bool(torch.where(gfin, (gd - true_g).abs() <= tol(true_g, gi), True).all()):
        raise AssertionError(f"{name}: a reported distance is not its id's distance")
    # tie-aware agreement: an id the plain version did not pick counts if its
    # own distance is within tolerance of the plain k-th distance
    in_set = (gi[:, :, None] == wi[:, None, :]).any(-1)
    tie = true_g <= wd[:, -1:] + tol(wd[:, -1:], wi[:, -1:])
    valid = wi >= 0
    agree = float(((in_set | tie) & gfin & valid).sum()) / max(int(valid.sum()), 1)
    if agree < AGREEMENT_GATE:
        raise AssertionError(f"{name}: id agreement {agree} < {AGREEMENT_GATE}")
    emit({"phase": "kernel_vs_plain", "case": name, "exact": False,
          "max_abs_err": max_err, "id_agreement": agree, "ok": True})
    return max_err


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from mpi_knn_tpu_torch import KNNClassifier, KNNConfig, all_knn
    from mpi_knn_tpu_torch.backends.serial import all_knn_serial
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build, fused_knn
    from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the exact policy needs full f32")
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    info = _build.build_all()
    for name, entry in info.items():
        print(entry["log"], file=sys.stderr)
        emit({"phase": "build", "source": f"csrc/{name}.cu",
              "seconds": entry["seconds"], "cached": entry["log"] == "cached"})

    kernels = {
        "fused_knn_tiles": (fused_knn.fused_knn_tiles,
                            fused_knn.fused_knn_tiles_reference),
        "fused_knn_sweep": (fused_knn.fused_knn_sweep,
                            fused_knn.fused_knn_sweep_reference),
    }
    # the corpus columns one output list covers: a corpus tile, or all of it
    spans = {"fused_knn_tiles": lambda ct, C: ct, "fused_knn_sweep": lambda ct, C: C}
    max_err = {name: 0.0 for name in kernels}
    for case, qp, cp, m, all_pairs, exact, k, qt, ct in kernel_cases(device):
        for name, (kern, plain) in kernels.items():
            args = (qp, cp, m, k, qt, ct)
            kw = dict(all_pairs=all_pairs)
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            err = compare(f"{name}/{case}", got, plain(*args, **kw), qp, cp, m,
                          all_pairs, exact, k, spans[name](ct, cp.shape[0]))
            max_err[name] = max(max_err[name], err)

    # ---- kernels alone at the main path's shapes -------------------------
    X, y = make_mnist_like(M_FULL)
    Xc = centered(X)
    qp = pad_rows_any(Xc, pad_to_multiple(M_FULL, Q_TILE), dtype=torch.float32,
                      device=device)
    cp = pad_rows_any(Xc, pad_to_multiple(M_FULL, C_TILE), dtype=torch.float32,
                      device=device)
    Q, D = qp.shape
    C = cp.shape[0]
    n_c = C // C_TILE
    timing = {}
    for name, (kern, plain) in kernels.items():
        args = (qp, cp, M_FULL, K, Q_TILE, C_TILE)
        got, want = kern(*args), plain(*args)  # also the warm-ups
        ms = cuda_ms(lambda: kern(*args), reps=3)
        plain_ms = cuda_ms(lambda: plain(*args), reps=3)
        err = compare(f"{name}/mnist60k_main_shape", got, want, qp, cp, M_FULL,
                      True, False, K, spans[name](C_TILE, C))
        max_err[name] = max(max_err[name], err)
        # the work the main path needs: its 60000 real queries against the
        # 60000 real corpus rows (padding rows and columns are not needed)
        out_slots = (n_c if name == "fused_knn_tiles" else 1) * M_FULL * K
        ops = 2.0 * M_FULL * M_FULL * D
        nbytes = 4.0 * (2 * M_FULL * D) + 8.0 * out_slots
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        timing[name] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": ops / (ms * 1e-3) / 1e12,
        }
        emit({"phase": "kernel_time", "kernel": name, "Q": Q, "C": C, "D": D,
              "k": K, **timing[name]})
    del qp, cp

    # the library yardstick: the serial backend (torch.matmul + stable sort)
    # on the same centered corpus, already on the card
    Xcd = torch.from_numpy(Xc).to(device)
    serial_cfg = KNNConfig(k=K, backend="serial")
    row_ids = np.arange(M_FULL, dtype=np.int32)

    def serial():
        return all_knn_serial(Xcd, Xcd, row_ids, serial_cfg, device)

    serial()  # warm-up
    library_ms = cuda_ms(serial, reps=3)
    emit({"phase": "library_time", "call": "backends.serial.all_knn_serial",
          "m": M_FULL, "d": D, "k": K, "ms": library_ms})
    del Xcd

    # ---- the main path ------------------------------------------------------
    sample = np.linspace(0, M_FULL - 1, num=256, dtype=np.int64)
    Xs = X.astype(np.float64)
    d = ((Xs[sample] ** 2).sum(1)[:, None] + (Xs ** 2).sum(1)[None, :]
         - 2.0 * (Xs[sample] @ Xs.T))
    d[d <= 1e-9] = np.inf  # the reference's zero exclusion
    d[np.arange(len(sample)), sample] = np.inf  # leave-one-out
    want_ids = np.argsort(d, axis=1, kind="stable")[:, :K]

    def recall(ids) -> float:
        got = ids[torch.as_tensor(sample, device=ids.device)].cpu().numpy()
        return float((want_ids[:, :, None] == got[:, None, :]).any(-1).mean())

    Xd = torch.from_numpy(X).to(device)

    def median_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, 1e3 * statistics.median(times), times

    def drive(backend, variant):
        """One main-path run, the LOO report: launch counts reset just
        before it and read just after. Then the timing reps (warm-up
        excluded): the host-input form is what KNNClassifier users call;
        the device-input form (corpus already on the card, centered there)
        is what the JAX package's bench times. Returns the JSON line."""
        clf = KNNClassifier(k=K, backend=backend, pallas_variant=variant,
                            device="cuda").fit(X, y)
        fused_knn.reset_launch_counts()
        report = clf.loo_report()  # the main path; also the timing warm-up
        counts = dict(fused_knn.LAUNCHES)
        res, host_ms, host_s = median_ms(lambda: clf.kneighbors(None))
        _, dev_ms, dev_s = median_ms(
            lambda: all_knn(Xd, config=clf.config, device=device))
        ids = report.result.ids
        if ids.shape != (M_FULL, K) or not bool(torch.isfinite(report.result.dists).all()):
            raise AssertionError(f"{backend}/{variant}: bad result shape or values")
        if not torch.equal(res.ids, ids):
            raise AssertionError(f"{backend}/{variant}: reps disagree")
        rec = recall(ids)
        line = {"phase": "main_path", "backend": backend, "variant": variant,
                "m": M_FULL, "d": D, "k": K, "allknn_ms_median": host_ms,
                "allknn_s_reps": host_s, "device_input_ms_median": dev_ms,
                "device_input_s_reps": dev_s, "matches": report.matches,
                "total": report.total, "recall_at_10": rec,
                "launches": counts}
        emit(line)
        if rec < RECALL_GATE:
            raise AssertionError(f"{backend}/{variant}: recall@10 {rec} < {RECALL_GATE}")
        return line

    launches = {}
    for variant, kname in (("tiles", "fused_knn_tiles"),
                           ("sweep", "fused_knn_sweep")):
        launches[kname] = drive("pallas", variant)["launches"][kname]
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")
    drive("serial", "tiles")

    replaces = {
        "fused_knn_tiles": "mpi_knn_tpu/ops/pallas_knn.py:249",
        "fused_knn_sweep": "mpi_knn_tpu/ops/pallas_knn.py:330",
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "mpi_knn_tpu_torch/csrc/fused_knn.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": library_ms}
        for name in kernels
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

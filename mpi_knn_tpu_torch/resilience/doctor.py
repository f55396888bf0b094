"""``python -m mpi_knn_tpu_torch doctor``: preflight health probe of the
card (the JAX package's ``resilience/doctor.py``).

Answers one operator question before a serving run: will a kernel of
this port actually launch and finish on this device, soon? The probe runs
in its own subprocess under the worker runner's heartbeat watchdog (a
wedged card wedges the probe child, never the caller), and the verdict is
one JSON line with exit status 0 / 1::

    python -m mpi_knn_tpu_torch doctor                   # the card
    python -m mpi_knn_tpu_torch doctor --platform cpu    # the plain kernels
    python -m mpi_knn_tpu_torch doctor --timeout 30      # beat-starvation bound
    python -m mpi_knn_tpu_torch doctor --cache-dir DIR   # + the cache round trip

The child prints four lines, which the supervisor folds into the verdict:

1. the device probe: one launch of K1 (``fused_knn_tiles``) on a 512×32
   corpus of small-integer values, held bit for bit against its plain
   version, with its launch count and the probe's seconds (on the CPU the
   plain version runs and launches nothing);
2. the child's registry snapshot: the probe's launches and seconds, and
   the nvcc builds it needed;
3. with a cache directory (``--cache-dir`` or ``TKNN_AOT_CACHE``), the
   cache's store / load round trip through the production entry format,
   on a card with the probe's own library (written back out and loaded);
4. the mutation probe: a throwaway 64-row clustered index takes upsert →
   query → delete → query twice; the second pass must build nothing, an
   upserted id must be found and a deleted one never come back.

``--platform auto`` is the card (the port's default device): a host whose
card is missing or broken fails the probe; it never probes the CPU in its
place. The reference's memory and plan lines (``doctor.py:141-213``) stand
on its static memory analysis and capacity planner, which the port does
not have: the verdict leaves them out.

Verdict schema: ``{"ok": bool, "status": "ok"|"timeout"|"crashed",
"probe": {...} | null, "metrics": <registry snapshot> | null,
"aot_cache": {...} | null, "mutation": {...} | null, "beats": N,
"last_beat": label, "elapsed_s": s, "reason": str|null,
"stderr_tail": str|null, "flight": <banked span summary> | null}``.

The supervisor half of this module imports no torch and never initializes
CUDA; only the child touches the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mpi_knn_tpu_torch.resilience.worker import python_worker_argv, run_supervised

DEFAULT_BEAT_TIMEOUT_S = 60.0
DEFAULT_WALL_TIMEOUT_S = 180.0
PLATFORMS = ("auto", "cpu", "cuda")


def _probe_child(platform: str, cache_dir: str | None = None) -> int:
    """The probe body, run inside the supervised worker subprocess. Beats
    bracket every step that can hang, so the supervisor's kill names the
    wedged step."""
    from mpi_knn_tpu_torch.resilience.faults import fault_point
    from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat

    maybe_beat("start")
    fault_point("doctor-probe")  # an injectable wedge
    import numpy as np
    import torch

    from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
    from mpi_knn_tpu_torch.obs.metrics import get_registry
    from mpi_knn_tpu_torch.ops import fused_knn
    from mpi_knn_tpu_torch.serve import aotcache

    maybe_beat("torch-import")
    dev = resolve_device(DEFAULT_DEVICE if platform == "auto" else platform)
    card = dev.type == "cuda"
    maybe_beat("platform")
    # the cache first, so the probe's own kernel library goes through it
    cache = (aotcache.set_cache_dir(cache_dir) if cache_dir
             else aotcache.active_cache())
    rng = np.random.default_rng(0)
    X = torch.from_numpy((rng.integers(0, 8, (512, 32)) * 0.25)
                         .astype(np.float32)).to(dev)
    before = fused_knn.LAUNCHES["fused_knn_tiles"]
    t0 = time.perf_counter()
    gd, gi = fused_knn.fused_knn_tiles(X, X, 512, 4, 128, 256)
    if card:
        torch.cuda.synchronize(dev)
    probe_s = time.perf_counter() - t0
    launches = fused_knn.LAUNCHES["fused_knn_tiles"] - before
    maybe_beat("kernel")
    wd, wi = fused_knn.fused_knn_tiles_reference(X, X, 512, 4, 128, 256)
    agrees = bool(torch.equal(gi, wi) and torch.equal(
        torch.nan_to_num(gd, posinf=-1.0), torch.nan_to_num(wd, posinf=-1.0)))
    print(json.dumps({
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if card else "cpu",
        "device_count": torch.cuda.device_count() if card else 1,
        "kernel": "fused_knn_tiles",
        "launches": launches,
        "agrees_with_plain": agrees,
        "kernel_probe_s": round(probe_s, 4),
    }), flush=True)
    # the registry: hard evidence of what the probe built and ran
    reg = get_registry()
    reg.counter("doctor_kernel_launches_total",
                help="kernel launches of the doctor's device probe").inc(launches)
    reg.histogram("doctor_probe_seconds",
                  help="wall time of the doctor's device probe").observe(probe_s)
    print(json.dumps({"metrics": reg.snapshot()}), flush=True)
    if cache is not None:
        maybe_beat("aot-cache-probe")
        lib = fused_knn._lib()._name if card else None
        rt = aotcache.probe_roundtrip(cache, library=lib)
        # stats after the round trip, so the count includes its entry
        print(json.dumps({"aot_cache": {**cache.stats(), **rt}}), flush=True)
        maybe_beat("aot-cache-done")
    maybe_beat("mutation-probe")
    print(json.dumps({"mutation": _mutation_probe(dev)}), flush=True)
    maybe_beat("mutation-done")
    return 0


def _mutation_probe(dev) -> dict:
    """A throwaway 64-row clustered index, upsert → query → delete →
    query, twice: pass 2's builds (nvcc or entry) are the verdict's
    evidence that sustained churn builds nothing."""
    import numpy as np

    from mpi_knn_tpu_torch.config import KNNConfig
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.obs.metrics import watch_compiles
    from mpi_knn_tpu_torch.serve import mutate as serve_mutate
    from mpi_knn_tpu_torch.serve.engine import query_knn

    rng = np.random.default_rng(0)
    cents = rng.standard_normal((4, 8)).astype(np.float32) * 6
    X = (cents[rng.integers(0, 4, 64)]
         + rng.standard_normal((64, 8)) * 0.1).astype(np.float32)
    index = build_ivf_index(X, KNNConfig(
        k=3, partitions=4, nprobe=4, kmeans_iters=4, query_tile=8,
        query_bucket=8, mutation_bucket=8, dispatch_depth=1,
        bucket_headroom=0.5,
    ), device=dev)

    def round_trip(base_id: int) -> dict:
        ids = np.arange(base_id, base_id + 4)
        rows = (cents[0] + rng.standard_normal((4, 8)) * 0.05).astype(np.float32)
        up = serve_mutate.upsert_rows(index, ids, rows)
        got = query_knn(rows, index, index.cfg, device=dev, k=3)
        found = bool(set(ids.tolist()) & set(got.ids.ravel().tolist()))
        serve_mutate.delete_rows(index, ids)
        got2 = query_knn(rows, index, index.cfg, device=dev, k=3)
        ghost = bool(set(ids.tolist()) & set(got2.ids.ravel().tolist()))
        return {"upserted": up["upserted"], "found": found, "ghost": ghost}

    pass1 = round_trip(1000)
    with watch_compiles() as builds:
        pass2 = round_trip(2000)
    ok = (pass1["found"] and pass2["found"] and not pass1["ghost"]
          and not pass2["ghost"] and not builds)
    return {"ok": ok, "pass1": pass1, "pass2": pass2,
            "second_pass_builds": len(builds)}


def run_probe(
    platform: str = "auto",
    beat_timeout_s: float = DEFAULT_BEAT_TIMEOUT_S,
    wall_timeout_s: float = DEFAULT_WALL_TIMEOUT_S,
    env: dict | None = None,
    cache_dir: str | None = None,
) -> dict:
    """Run the supervised probe and build the verdict document."""
    argv = ["-m", "mpi_knn_tpu_torch", "doctor", "--child", "--platform",
            platform]
    if cache_dir:
        argv += ["--cache-dir", cache_dir]
    res = run_supervised(python_worker_argv(*argv), env=env,
                         beat_timeout_s=beat_timeout_s,
                         wall_timeout_s=wall_timeout_s)
    lines = {}
    if res.ok:
        for line in res.stdout.splitlines():
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(doc, dict) and "device_count" in doc:
                lines["probe"] = doc
            elif isinstance(doc, dict) and len(doc) == 1:
                lines.update(doc)
    probe = lines.get("probe")
    aot = lines.get("aot_cache")
    mutation = lines.get("mutation")
    healthy = (
        probe is not None and probe["agrees_with_plain"]
        and (probe["platform"] == "cpu" or probe["launches"] == 1)
        and (aot is None or (aot["store_ok"] and aot["load_ok"]
                             and aot["bit_identical"]
                             and aot.get("dlopen_ok", True)))
        and mutation is not None and mutation["ok"]
    )
    return {
        "ok": bool(res.ok and healthy),
        # rc 0 without the probe's lines is a broken child
        "status": res.status if probe is not None or not res.ok else "crashed",
        "probe": probe,
        "metrics": lines.get("metrics"),
        "aot_cache": aot,
        "mutation": mutation,
        "beats": res.beats,
        "last_beat": res.last_beat_label,
        "elapsed_s": round(res.duration_s, 3),
        "reason": res.reason,
        "stderr_tail": None if res.ok else res.stderr_tail,
        # a killed probe's span story (open spans name the wedged step)
        "flight": res.flight,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch doctor",
        description="preflight device health probe (a kernel launch held "
        "against its plain version, in a heartbeat-supervised subprocess); "
        "exit 0 iff healthy, JSON verdict on stdout",
    )
    p.add_argument("--platform", choices=PLATFORMS, default="auto",
                   help="auto: the card (the port's default device); cpu: "
                   "the plain kernels")
    p.add_argument("--timeout", type=float, default=DEFAULT_BEAT_TIMEOUT_S,
                   help="beat-starvation bound in seconds (progress gaps "
                   "longer than this kill the probe)")
    p.add_argument("--wall-timeout", type=float,
                   default=DEFAULT_WALL_TIMEOUT_S,
                   help="outer wall-clock bound in seconds")
    p.add_argument("--report", default=None,
                   help="also write the JSON verdict to this path")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="probe this persistent kernel cache "
                   "(serve/aotcache.py; TKNN_AOT_CACHE is honored without "
                   "the flag): the verdict gains an aot_cache block")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.child:
        return _probe_child(args.platform, cache_dir=args.cache_dir)
    verdict = run_probe(platform=args.platform, beat_timeout_s=args.timeout,
                        wall_timeout_s=args.wall_timeout, env=dict(os.environ),
                        cache_dir=args.cache_dir)
    print(json.dumps(verdict), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(verdict, f, indent=1)
            f.write("\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

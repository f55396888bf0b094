"""``python -m mpi_knn_tpu_torch mutate``: live mutation of a saved
clustered index (the JAX package's ``serve/mutate_cli.py``, offline mode,
with ``--device`` in place of ``--platform``).

Load a saved ``.npz`` (either package's), apply upserts, deletes and a
compaction, and save it again atomically (``utils/atomicio.py``), so a
process loading the path never sees a torn file::

    python -m mpi_knn_tpu_torch mutate --index sift.ivf.npz --delete 17,42,99
    python -m mpi_knn_tpu_torch mutate --index sift.ivf.npz \\
        --upsert-rows new.npy --ids 1000000:1000128 --out sift.v2.npz
    python -m mpi_knn_tpu_torch mutate --index sift.ivf.npz --compact
    python -m mpi_knn_tpu_torch mutate --index sift.ivf.npz --stats

Ids: ``--ids`` takes ``START:STOP`` (half-open) or a comma list; upsert
rows come from a ``.npy`` file (``--upsert-rows``) or ``--synthetic N``
(seeded standard-normal rows). Every run prints one JSON line per action
and a last line with the saved path and the freelist's stats; exit 0 on
success, 2 on usage errors, 1 when the headroom is exhausted.

``--cache-dir`` (or ``TKNN_AOT_CACHE``) points the process at the
persistent cache of kernel libraries (``serve/aotcache.py``).

Not yet ported (exit 2): the online mode (``--url``, ``--tenant``: it
needs the serving front end).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mpi_knn_tpu_torch.device import DEFAULT_DEVICE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch mutate",
        description="live index mutation: upsert/delete/compact a saved "
        "clustered index and save it again",
    )
    tgt = p.add_mutually_exclusive_group(required=True)
    tgt.add_argument("--index", metavar="PATH.npz",
                     help="a save_ivf_index file to mutate and save again")
    tgt.add_argument("--url", metavar="URL",
                     help="online mode (a running server): not yet ported")
    p.add_argument("--tenant", default=None,
                   help="tenant of online mutations: not yet ported")
    p.add_argument("--ids", default=None, metavar="SPEC",
                   help="ids as START:STOP (half-open) or a comma list: the "
                   "upsert ids")
    p.add_argument("--upsert-rows", default=None, metavar="FILE.npy",
                   help="(n, dim) f32 rows to upsert under --ids")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="upsert N seeded standard-normal rows instead of "
                   "--upsert-rows")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--delete", default=None, metavar="SPEC",
                   help="ids to tombstone (START:STOP or comma list)")
    p.add_argument("--compact", action="store_true",
                   help="run a re-cluster/compact pass")
    p.add_argument("--no-retrain", action="store_true",
                   help="compact without retraining centroids")
    p.add_argument("--stats", action="store_true",
                   help="print the freelist occupancy stats "
                   "(live/tombstones/fill) and exit")
    p.add_argument("--out", default=None, metavar="PATH.npz",
                   help="write the mutated index here (default: overwrite "
                   "--index atomically)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="persistent cache of the kernel libraries "
                   "(serve/aotcache.py; also TKNN_AOT_CACHE)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' mutates on the "
                   "CPU)")
    return p


def _parse_ids(spec: str) -> np.ndarray:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return np.arange(int(lo), int(hi), dtype=np.int64)
    return np.asarray([int(v) for v in spec.split(",") if v], dtype=np.int64)


def _emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def _usage(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, value in (("--url", args.url), ("--tenant", args.tenant)):
        if value is not None:
            return _usage(f"{flag}: not yet ported to mpi_knn_tpu_torch (see "
                          "ROADMAP.md)")

    upsert_ids = rows = None
    if args.upsert_rows or args.synthetic:
        if args.ids is None:
            return _usage("--upsert-rows/--synthetic need --ids (the "
                          "global ids the rows land under)")
        upsert_ids = _parse_ids(args.ids)
        if args.upsert_rows:
            rows = np.load(args.upsert_rows)
            if rows.shape[0] != len(upsert_ids):
                return _usage(f"{len(upsert_ids)} ids but {rows.shape[0]} rows")
    elif args.ids and not args.delete:
        return _usage("--ids without --upsert-rows/--synthetic/--delete "
                      "names rows but no action")
    delete_ids = _parse_ids(args.delete) if args.delete else None
    if not any((upsert_ids is not None, delete_ids is not None,
                args.compact, args.stats)):
        return _usage("nothing to do: give --upsert-rows/--synthetic, "
                      "--delete, --compact, or --stats")

    if args.cache_dir:
        from mpi_knn_tpu_torch.serve import aotcache

        aotcache.set_cache_dir(args.cache_dir)
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.ivf import load_ivf_index, save_ivf_index
    from mpi_knn_tpu_torch.serve import mutate as serve_mutate

    index = load_ivf_index(args.index, device=resolve_device(args.device))
    if args.stats and upsert_ids is None and delete_ids is None \
            and not args.compact:
        _emit({"action": "stats", **serve_mutate.mutation_stats(index)})
        return 0
    if rows is None and upsert_ids is not None:
        rng = np.random.default_rng(args.seed)
        rows = rng.standard_normal((len(upsert_ids), index.dim)).astype(np.float32)
    try:
        if upsert_ids is not None:
            _emit({"action": "upsert",
                   **serve_mutate.upsert_rows(index, upsert_ids, rows)})
        if delete_ids is not None:
            _emit({"action": "delete",
                   **serve_mutate.delete_rows(index, delete_ids)})
        if args.compact:
            _emit({"action": "compact",
                   **serve_mutate.compact_index(index,
                                                retrain=not args.no_retrain)})
    except serve_mutate.BucketOverflowError as e:
        _emit({"action": "error", "error": "headroom-exhausted",
               "detail": str(e)})
        return 1
    out = args.out or args.index
    save_ivf_index(index, out)
    _emit({"action": "saved", "path": out, **serve_mutate.mutation_stats(index)})
    return 0


if __name__ == "__main__":
    sys.exit(main())

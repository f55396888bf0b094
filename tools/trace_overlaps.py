"""Whether the device events of a ``torch.profiler`` trace overlap on
their stream, read two ways: parsed exactly (``obs/kineto.py``: the
trace's decimal ``ts`` / ``dur`` as integer picoseconds) and by float
arithmetic (``int(round(float(x) * 1e6))``, how the parser read them
before it was made exact). One JSON line a trace file and device plane:
events, summed durations and their union per stream (ps), the excess,
the overlapping pairs of consecutive events, the largest overlap, the
closest gap between two events of one stream, and a few of the pairs.

With ``--run-cli N`` it first takes N profiled runs of the run CLI's
serial twolevel approx window at the main shape (``--data mnist --k 10
--loo --backend serial --topk-method approx --profile``; 1770 launches of
the bin minimum), each into a directory of its own under ``path``; the
smoke's ``profile`` phase gates the same window. Needs a card for that.

    python3 tools/trace_overlaps.py --run-cli 6 /tmp/traces
    python3 tools/trace_overlaps.py /path/to/kept/traces
"""

import argparse
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpi_knn_tpu_torch.obs import kineto  # noqa: E402


def float_parse(raw: bytes) -> list:
    """The events as the float arithmetic reads them."""
    ps, loads = kineto._ps, kineto.json.loads
    kineto._ps = lambda x, what: int(round(float(x) * 1e6))
    kineto.json.loads = lambda r, parse_float=None: loads(r)
    try:
        return kineto.parse_trace_bytes(raw)
    finally:
        kineto._ps, kineto.json.loads = ps, loads


def plane_report(events: list, plane: str) -> dict:
    summed, union = kineto.stream_busy_ps(events, plane)
    pairs, n, largest, closest = [], 0, 0, None
    for line, iv in kineto._stream_intervals(events, plane).items():
        for (a0, a1, an), (b0, b1, bn) in zip(iv, iv[1:]):
            gap = b0 - a1
            closest = gap if closest is None else min(closest, gap)
            if gap < 0:
                n += 1
                largest = max(largest, min(a1, b1) - b0)
                if len(pairs) < 5:
                    pairs.append([line, an[:60], a0, a1, bn[:60], b0, b1])
    return {"events": sum(1 for e in events if e["plane"] == plane),
            "summed_ps": summed, "union_ps": union, "excess_ps": summed - union,
            "overlapping_pairs": n, "largest_overlap_ps": largest,
            "closest_gap_ps": closest, "first_pairs": pairs}


def report(root: str) -> None:
    for f in kineto.find_traces(root):
        with open(f, "rb") as fh:
            raw = fh.read()
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        out = {"file": os.path.relpath(f, root), "bytes": len(raw)}
        try:
            parsed = (("exact", kineto.parse_trace_bytes(raw)), ("float", float_parse(raw)))
        except kineto.ParseError as e:  # a report written beside the traces
            print(json.dumps({**out, "not_a_trace": str(e)}), flush=True)
            continue
        for label, events in parsed:
            for plane in sorted({e["plane"] for e in events
                                 if e["plane"].startswith("/device")}):
                out[f"{label} {plane}"] = plane_report(events, plane)
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="a trace file or a directory of traces")
    ap.add_argument("--run-cli", type=int, default=0, metavar="N",
                    help="first take N profiled runs of the run CLI's serial "
                    "twolevel approx window into PATH (a card)")
    args = ap.parse_args(argv)
    if args.run_cli:
        from mpi_knn_tpu_torch import cli

        for r in range(args.run_cli):
            rc = cli.main(["--data", "mnist", "--k", "10", "--loo", "--backend",
                           "serial", "--topk-method", "approx", "--profile",
                           os.path.join(args.path, f"run{r}"), "-q"])
            if rc != 0:
                print(f"run {r}: the run CLI exited {rc}", file=sys.stderr)
                return rc
    report(args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

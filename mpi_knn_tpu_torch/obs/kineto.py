"""Kineto (``torch.profiler``) Chrome-trace parser and per-op aggregation:
the port's counterpart of the JAX package's ``obs/xplane.py``, the
library behind the serving session's device-time attribution
(``obs/attribution.py``, ``ServeSession.profile``).

``torch.profiler`` writes Chrome trace-event JSON (``export_chrome_trace``,
``tensorboard_trace_handler``; ``.json`` or ``.json.gz``): a
``traceEvents`` list of complete events (``"ph": "X"``) with ``ts`` and
``dur`` in microseconds. This module turns it into the reference's event
dicts ``{plane, line, name, start_ps, dur_ps}``:

- device activity (categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``)
  goes on a plane named ``/device:GPU:<i>``, one line per stream. These
  events are flat: a stream runs one at a time;
- host operations (``cpu_op``, ``user_annotation``, ``cuda_runtime``,
  ``cuda_driver``, ``python_function``) go on ``/host:CPU``, one line per
  thread. They nest (``aten::linear`` ⊃ ``aten::matmul`` ⊃ ``aten::mm``),
  so each is cut to its SELF time, the parts of its span no child covers:
  summing nested durations would count a child twice and break the
  invariant that the categories sum to the busy total;
- everything else (the window's own ``Trace`` span, device-side
  annotations, flow and metadata records) is not an operation and is
  left out, and so is torch's spin kernel (``torch.cuda._sleep``), with
  which ``utils/timing.profile_trace`` opens a window on a card: a
  session can lose its first device records, and the primer's launches
  take that loss in place of the work traced.

Truncated or malformed input raises :class:`ParseError`, as
``xplane.py`` does: a silent misparse would corrupt every number
downstream.

:func:`analyze` is the reference's aggregation over the parsed events,
unchanged: top ops by total duration, busy time per category, and the
collective-under-matmul overlap (busy intervals, and async
``-start``/``-done`` spans, which a CUDA trace does not have). Categories
are the reference's six; :func:`categorize` first looks a name up in
:data:`KERNEL_CATEGORIES`, the explicit table of this repository's hand
kernels (K1–K5 are ``matmul``, as a fused Pallas kernel is in the
reference; the bin minimum is ``sort-topk``; the ``stage_*`` prologues
are ``copy``), then in :data:`TORCH_PATTERNS` (cuBLAS / cuDNN GEMMs,
torch's sorts and top-k, memcpy / memset; a peer-to-peer copy between two
ranks' cards is ``collective``, since it is the port's ring transport),
and then applies the reference's rules. ``dma-wait`` never occurs in a
CUDA trace: K4's in-kernel waits on its neighbours' flags emit no events,
so that time is inside the kernel's own duration.
"""

from __future__ import annotations

import decimal
import glob
import gzip
import json
import os
from collections import defaultdict

# the reference's aggregation and rules, copied (the port imports nothing
# of the JAX package)

CATEGORIES = (
    ("dma-wait", ("dma-wait", "dma_wait", "dmawait", "wait-semaphore",
                  "semaphore-wait", "sem-wait", "semaphore_wait",
                  "wait_semaphore", "wait-dma", "wait_dma")),
    ("collective", ("collective-permute", "all-reduce", "all-gather",
                    "all-to-all", "ppermute", "reduce-scatter",
                    "collective")),
    ("sort-topk", ("sort", "top-k", "topk", "partial-reduce", "approx")),
    ("matmul", ("dot", "convolution", "matmul", "fusion")),
    ("copy", ("copy", "transpose", "reshape", "dynamic-slice",
              "dynamic-update-slice", "pad", "concatenate")),
)

# every __global__ function of csrc/: its category
KERNEL_CATEGORIES = {
    # K1, K2 (exact: the wgmma TF32x3 tile; compress: bf16)
    "fused_knn_tiles_kernel": "matmul",
    "fused_knn_sweep_kernel": "matmul",
    "fused_knn_tiles_compress_kernel": "matmul",
    "fused_knn_sweep_compress_kernel": "matmul",
    "fused_knn_bf16x1_kernel": "matmul",  # K1 / K2 at "default"
    "fused_knn_bf16x3_kernel": "matmul",  # K1 / K2 at "high"
    # K3a, K3b
    "block_merge_exact_kernel": "matmul",
    "block_merge_compress_kernel": "matmul",
    # K4, K5
    "round_dma_kernel_wgmma": "matmul",
    "round_dma_kernel": "matmul",
    "rotation_grid_kernel": "matmul",
    # the bin minimum (lax.approx_min_k)
    "warp_chunks_kernel": "sort-topk",
    "cta_row_kernel": "sort-topk",
    "merge_lists_kernel": "sort-topk",
    # the prologues
    "stage_split_kernel": "copy",
    "stage_bf16_kernel": "copy",
    "stage_tf32_kernel": "copy",
    "stage_planes_kernel": "copy",
    # test and measurement hooks
    "exact_tile_dots_kernel": "matmul",
    "split_tile_dots_kernel": "matmul",
    "bf16_tile_dots_kernel": "matmul",
    "mma_rate_kernel": "matmul",
    "wgmma_rate_kernel": "matmul",
}

# the hand kernels against the port's launch counters: (symbols, counter
# names); each family's launches in a trace equal the sum of its counters.
# merge_lists_kernel is the second pass of an approx_min_k launch, counted
# with its first.
KERNEL_FAMILIES = (
    (("fused_knn_tiles_kernel",), ("fused_knn_tiles",)),
    (("fused_knn_sweep_kernel",), ("fused_knn_sweep",)),
    (("fused_knn_tiles_compress_kernel",), ("fused_knn_tiles[compress]",)),
    (("fused_knn_sweep_compress_kernel",), ("fused_knn_sweep[compress]",)),
    (("fused_knn_bf16x1_kernel",),
     ("fused_knn_tiles[default]", "fused_knn_sweep[default]")),
    (("fused_knn_bf16x3_kernel",),
     ("fused_knn_tiles[high]", "fused_knn_sweep[high]")),
    (("block_merge_exact_kernel",),
     ("fused_block_merge[exact]", "fused_block_merge[default]",
      "fused_block_merge[high]")),
    (("block_merge_compress_kernel",), ("fused_block_merge[compress]",)),
    (("round_dma_kernel_wgmma", "round_dma_kernel"),
     ("fused_round_dma", "fused_round_dma[default]", "fused_round_dma[high]")),
    (("rotation_grid_kernel",),
     ("fused_rotation_grid", "fused_rotation_grid[default]",
      "fused_rotation_grid[high]")),
    (("stage_split_kernel",), ("stage_tf32_split", "stage_tf32_split[ring]")),
    (("stage_bf16_kernel",), ("stage_bf16", "stage_bf16[wire]")),
    (("stage_tf32_kernel",), ("stage_tf32[wire]", "stage_norms")),
    (("stage_planes_kernel",), ("stage_planes",)),
    (("warp_chunks_kernel", "cta_row_kernel"),
     ("approx_min_k", "approx_min_k[f64]")),
)

# torch's and the CUDA libraries' names (lower case, substring), before the
# reference's rules; the peer copy comes before every other copy
TORCH_PATTERNS = (
    ("collective", ("memcpy ptop", "memcpy peer", "nccl")),
    ("matmul", ("gemm", "gemv", "aten::mm", "aten::addmm", "aten::bmm",
                "aten::baddbmm", "aten::linear", "aten::einsum", "cublas",
                "cutlass")),
    ("sort-topk", ("radixsort", "aten::topk", "aten::sort", "aten::argsort",
                   "aten::kthvalue")),
    ("copy", ("memcpy", "memset")),
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
HOST_PLANE = "/host:CPU"
PRIMER_SYMBOL = "spin_kernel"  # torch.cuda._sleep: a window's primer


class ParseError(ValueError):
    """A malformed Kineto trace (truncated or not JSON, no event list, an
    event without numeric times)."""


def kernel_symbol(name: str) -> str:
    """The function's identifier in a demangled kernel name:
    ``void (anonymous namespace)::warp_chunks_kernel<float>(Args<float>,
    ...)`` → ``warp_chunks_kernel``."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    for stop in ("(", "<"):
        s = s.split(stop, 1)[0]
    return s.rsplit("::", 1)[-1].strip()


def categorize(name: str) -> str:
    cat = KERNEL_CATEGORIES.get(kernel_symbol(name))
    if cat is not None:
        return cat
    low = name.lower()
    for table in (TORCH_PATTERNS, CATEGORIES):
        for cat, keys in table:
            if any(k in low for k in keys):
                return cat
    return "other"


def _ps(x, what: str) -> int:
    """Microseconds → integer picoseconds, exactly: the trace's decimals
    are parsed as :class:`decimal.Decimal`, because a float64 at
    ``ts`` ≈ 1.46e12 µs steps by 244 ps, and two events that abut in the
    file could otherwise overlap (or part) by a fraction of a nanosecond
    once parsed."""
    if isinstance(x, bool) or not isinstance(x, (int, float, decimal.Decimal)):
        raise ParseError(f"event {what} is not a number: {x!r}")
    ps = decimal.Decimal(x) * _PS_PER_US
    if not ps.is_finite():
        raise ParseError(f"event {what} is not finite: {x!r}")
    return int(ps.to_integral_value(rounding=decimal.ROUND_HALF_EVEN))


_PS_PER_US = decimal.Decimal(1_000_000)


def _self_time(evs: list) -> list:
    """One thread's nested host events cut to their self time: each event
    becomes the pieces of its span that no child covers (children clipped
    to their parent), so no time is counted twice."""
    out = []
    evs = sorted(evs, key=lambda e: (e["start_ps"], -e["dur_ps"]))
    stack = []  # [event, end, cursor]: the open ancestors, innermost last

    def close(top):
        ev, end, cur = top
        if end > cur:
            out.append({**ev, "start_ps": cur, "dur_ps": end - cur})

    for ev in evs:
        s, e = ev["start_ps"], ev["start_ps"] + ev["dur_ps"]
        while stack and s >= stack[-1][1]:
            close(stack.pop())
        if stack:
            parent = stack[-1]
            e = min(e, parent[1])
            if s > parent[2]:
                out.append({**parent[0], "start_ps": parent[2],
                            "dur_ps": s - parent[2]})
            parent[2] = max(parent[2], e)
        stack.append([ev, e, s])
    while stack:
        close(stack.pop())
    return out


def parse_trace_bytes(raw: bytes) -> list[dict]:
    """Parse one Chrome / Kineto trace (JSON bytes; gzip is detected);
    returns ``[{plane, line, name, start_ps, dur_ps}]``."""
    if raw[:2] == b"\x1f\x8b":
        try:
            raw = gzip.decompress(raw)
        except (OSError, EOFError) as e:
            raise ParseError(f"bad gzip stream: {e}") from e
    try:
        doc = json.loads(raw, parse_float=decimal.Decimal)
    except (UnicodeDecodeError, ValueError, decimal.InvalidOperation) as e:
        raise ParseError(f"not a JSON trace: {e}") from e
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ParseError("no traceEvents list")
    device, host = [], defaultdict(list)
    for ev in events:
        if not isinstance(ev, dict):
            raise ParseError(f"trace event is not an object: {ev!r}")
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat not in DEVICE_CATS and cat not in HOST_CATS:
            continue
        name = ev.get("name")
        if not isinstance(name, str):
            raise ParseError(f"event without a name: {ev!r}")
        start, dur = _ps(ev.get("ts"), "ts"), _ps(ev.get("dur"), "dur")
        if dur < 0:
            raise ParseError(f"negative duration: {ev!r}")
        args = ev.get("args") if isinstance(ev.get("args"), dict) else {}
        if cat in DEVICE_CATS:
            if kernel_symbol(name) == PRIMER_SYMBOL:
                continue
            dev = args.get("device", ev.get("pid", 0))
            device.append({"plane": f"/device:GPU:{dev}",
                           "line": f"stream {args.get('stream', ev.get('tid'))}",
                           "name": name, "start_ps": start, "dur_ps": dur})
        else:
            tid = ev.get("tid")
            host[(ev.get("pid"), tid)].append({
                "plane": HOST_PLANE, "line": f"thread {tid}", "name": name,
                "start_ps": start, "dur_ps": dur})
    out = device
    for key in sorted(host, key=str):
        out.extend(_self_time(host[key]))
    return out


def parse_trace(path: str) -> list[dict]:
    """:func:`parse_trace_bytes` over a file (``.gz`` transparently)."""
    with open(path, "rb") as f:
        return parse_trace_bytes(f.read())


def find_traces(path: str) -> list[str]:
    """The trace files under ``path`` (or ``path`` itself): ``*.json`` and
    ``*.json.gz``, as ``export_chrome_trace`` and
    ``tensorboard_trace_handler`` write them."""
    if os.path.isfile(path):
        return [path]
    out = []
    for pat in ("**/*.json", "**/*.json.gz"):
        out.extend(glob.glob(os.path.join(path, pat), recursive=True))
    return sorted(out)


def kernel_counts(events: list) -> dict:
    """Launches per kernel symbol on the device planes."""
    counts: dict = defaultdict(int)
    for ev in events:
        if ev["plane"].startswith("/device:"):
            counts[kernel_symbol(ev["name"])] += 1
    return dict(counts)


def launch_mismatches(events: list, counters: dict) -> list:
    """Every hand-kernel family whose launches in the trace differ from the
    port's launch counters over the same window: ``[{symbols, counters,
    trace, counted}]`` (empty: the trace saw every counted launch, and no
    other)."""
    seen = kernel_counts(events)
    bad = []
    for symbols, names in KERNEL_FAMILIES:
        trace = sum(seen.get(s, 0) for s in symbols)
        counted = sum(int(counters.get(n, 0)) for n in names)
        if trace != counted:
            bad.append({"symbols": list(symbols), "counters": list(names),
                        "trace": trace, "counted": counted})
    return bad


def _stream_intervals(events: list, plane: str) -> dict:
    """The ``plane``'s events with a duration, per line (stream), as
    sorted ``(start_ps, end_ps, name)``."""
    lines: dict = {}
    for e in events:
        if e["plane"] == plane and e["dur_ps"]:
            lines.setdefault(e["line"], []).append(
                (e["start_ps"], e["start_ps"] + e["dur_ps"], e["name"]))
    for iv in lines.values():
        iv.sort()
    return lines


def stream_busy_ps(events: list, plane: str) -> tuple[int, int]:
    """(the summed durations, the union of the intervals), in integer
    picoseconds, of the ``plane``'s events, stream by stream: a stream runs
    one operation at a time, so the two differ only where an event was
    recorded twice or overlaps another on its stream."""
    total = union = 0
    for iv in _stream_intervals(events, plane).values():
        total += sum(b - a for a, b, _ in iv)
        end = None
        for a, b, _ in iv:
            if end is None or a >= end:
                union += b - a
                end = b
            elif b > end:
                union += b - end
                end = b
    return total, union


def stream_overlaps(events: list, plane: str, limit: int = 5) -> list:
    """Up to ``limit`` pairs of the ``plane``'s events that overlap on one
    stream: (stream, earlier name, its [start, end) ps, later name, its
    [start, end) ps). A duplicate record and an event inside another are
    both such pairs."""
    found = []
    for line, iv in _stream_intervals(events, plane).items():
        for (a0, a1, an), (b0, b1, bn) in zip(iv, iv[1:]):
            if b0 < a1 and len(found) < limit:
                found.append((line, an, (a0, a1), bn, (b0, b1)))
    return found


def overlap_ps(a: list, b: list) -> int:
    """Total overlap between two interval lists [(start, end)] (merged)."""

    def merge(iv):
        iv = sorted(iv)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    a, b = merge(a), merge(b)
    i = j = tot = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def analyze(events: list, top: int = 15):
    """Per plane: busy ms by category, top ops, and the collective /
    matmul overlap (the reference's ``xplane.analyze``)."""
    planes = defaultdict(list)
    for ev in events:
        planes[ev["plane"]].append(ev)
    report = {}
    for plane, evs in planes.items():
        by_op = defaultdict(int)
        by_cat = defaultdict(int)
        cat_iv = defaultdict(list)
        for ev in evs:
            if not ev["dur_ps"]:
                continue
            by_op[ev["name"]] += ev["dur_ps"]
            cat = categorize(ev["name"])
            by_cat[cat] += ev["dur_ps"]
            cat_iv[cat].append((ev["start_ps"], ev["start_ps"] + ev["dur_ps"]))
        if not by_op:
            continue
        coll_under_mm = overlap_ps(cat_iv.get("collective", []),
                                   cat_iv.get("matmul", []))
        # async '<op>-start' / '<op>-done' pairs: the in-flight span between
        # them, paired by name stem and order (unequal counts: skipped)
        starts, dones = defaultdict(list), defaultdict(list)
        for ev in evs:
            if not ev["dur_ps"] or categorize(ev["name"]) != "collective":
                continue
            low = ev["name"].lower()
            iv = (ev["start_ps"], ev["start_ps"] + ev["dur_ps"])
            if "-start" in low:
                starts[low.replace("-start", "", 1)].append(iv)
            elif "-done" in low:
                dones[low.replace("-done", "", 1)].append(iv)
        spans = []
        for stem, ss in starts.items():
            ds = dones.get(stem, [])
            if len(ds) != len(ss):
                continue
            for (s0, _), (_, d1) in zip(sorted(ss), sorted(ds)):
                if d1 > s0:
                    spans.append((s0, d1))
        span_under_mm = overlap_ps(spans, cat_iv.get("matmul", []))
        report[plane] = {
            "busy_ms_by_category": {
                k: round(v / 1e9, 3) for k, v in sorted(by_cat.items())
            },
            "collective_total_ms": round(
                sum(e - s for s, e in cat_iv.get("collective", [])) / 1e9, 3),
            "collective_overlapped_with_matmul_ms": round(coll_under_mm / 1e9, 3),
            "collective_span_ms": round(sum(e - s for s, e in spans) / 1e9, 3),
            "collective_span_overlapped_with_matmul_ms": round(
                span_under_mm / 1e9, 3),
            "top_ops_ms": {
                k: round(v / 1e9, 3)
                for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
            },
        }
    return report

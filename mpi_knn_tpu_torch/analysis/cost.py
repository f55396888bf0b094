"""Device profiles, closed-form FLOP counts and the roofline — the torch-free
half of the JAX package's ``analysis/cost.py`` (its lines 68-127 and
396-463), which the capacity planner (``mpi_knn_tpu_torch/plan.py``) and
the serving surfaces read.

A declared **device profile** (peak FLOP/s, HBM bandwidth, link
bandwidth, device memory — shipped as data in ``device_profiles.json``,
never code) turns a batch's FLOPs and bytes into a roofline lower bound
on its wall-clock and an upper bound on its queries/s. The port ships two
profiles: ``cpu-test`` (the JAX package's nominal CPU figures, unchanged,
so the planners agree on the CPU) and one for the H100 the port runs on,
each figure of which names its source in the file.

The half of the reference that reads XLA HLO (its dot inventory,
collective census, HBM-traffic model, cost ledger and rule R8) reads a
recorded eager run here instead (``utils/op_trace.py``): :func:`r8_check`
holds the run's counted product FLOPs to the closed form, and
:func:`cost_entry` is the cost ledger's entry.

Torch-free at import: :func:`detected_profile` imports torch lazily.
"""

from __future__ import annotations

import json
import pathlib

_PROFILES_PATH = pathlib.Path(__file__).parent / "device_profiles.json"
DEFAULT_PROFILE = "cpu-test"
H100_PROFILE = "h100-sxm-80gb"


def load_profiles() -> dict:
    """The shipped device profiles, keyed by name. Each profile declares
    ``peak_flops`` (FLOP/s), ``hbm_bw`` / ``ici_bw`` (bytes/s), and
    ``hbm_bytes`` (per-device capacity, used by the planner), and its
    sources in ``_doc``. Top-level keys starting with ``_`` are
    documentation and are skipped."""
    doc = json.loads(_PROFILES_PATH.read_text())
    return {k: v for k, v in doc.items() if not k.startswith("_")}


def get_profile(name: str) -> dict:
    profiles = load_profiles()
    if name not in profiles:
        raise KeyError(
            f"unknown device profile {name!r} (shipped: "
            f"{', '.join(sorted(profiles))})"
        )
    return profiles[name]


def profile_for_device(platform: str, name: str = "") -> str | None:
    """The shipped profile of a torch device type and card name: ``cpu``
    is ``cpu-test``, a CUDA card whose name contains "H100" the H100
    profile; any other card ``None`` (absent, never a guessed
    profile)."""
    if platform == "cpu":
        return DEFAULT_PROFILE
    if platform == "cuda" and "H100" in name:
        return H100_PROFILE
    return None


def detected_profile(device=None) -> dict | None:
    """The declared profile facts of ``device`` (default: the card when
    one is visible, else the CPU): ``{"name", ...}`` with the profile's
    numbers inlined, or ``None`` off the map. ``/healthz`` and the serve
    report stamp it, so an operator reads measured throughput next to
    the roofline inputs the planner predicted it under."""
    try:
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    except Exception:
        return None
    name = profile_for_device(dev.type, card)
    if name is None:
        return None
    return {"name": name, **get_profile(name)}


# ---------------------------------------------------------------------------
# closed-form FLOPs from declared configuration facts

def analytical_mxu_flops(facts: dict) -> int:
    """Closed-form matrix FLOPs from declared configuration facts (the
    JAX package's schemes, unchanged).

    - ``zero``: mutation programs — no products by design.
    - ``dense``: ``sites·trips·(2·q·c·d + 2·q·rblocks·w·d)`` — the tile
      distance product over a ``(q, c)`` block plus, on mixed configs,
      the survivor rerank of ``w`` overfetched rows per rerank block;
      the ring sets ``trips`` to its rounds and ``c`` to the rotating
      corpus block.
    - ``ivf``: ``2·q·partitions·d`` centroid scoring plus ``2·q·v·d``
      over the probed width ``v = nprobe·bucket_cap`` plus the mixed
      rerank ``2·q·rblocks·w·d``; the sharded layout runs the same work
      at its per-shard ``q``.
    - ``assign`` (the port's): a clustered mutation's centroid score of
      the ``rows`` it places, ``2·rows·partitions·d`` (the JAX package
      scores them outside the mutation program it lints).
    """
    scheme = facts["scheme"]
    if scheme == "zero":
        return 0
    if scheme == "assign":
        return 2 * facts["rows"] * facts["partitions"] * facts["d"]
    d = facts["d"]
    q = facts["q"]
    w = facts.get("w", 0)
    rblocks = facts.get("rblocks", 0)
    if scheme == "dense":
        sites = facts.get("sites", 1)
        trips = facts.get("trips", 1)
        return sites * trips * (
            2 * q * facts["c"] * d + 2 * q * rblocks * w * d
        )
    if scheme == "ivf":
        v = facts["nprobe"] * facts["bucket_cap"]
        return (
            2 * q * facts["partitions"] * d
            + 2 * q * v * d
            + 2 * q * rblocks * w * d
        )
    raise ValueError(f"unknown cost scheme {scheme!r}")


def roofline(flops: int, hbm_bytes: int, ici_bytes: int, queries: int,
             profile: dict) -> dict:
    """The roofline lower bound on wall-clock for one execution under a
    declared device profile, and the queries/s upper bound it implies.
    ``bound`` names the binding resource (the JAX package's leg names:
    ``mxu`` the matrix units, ``hbm`` device memory, ``ici`` the
    link)."""
    legs = {
        "mxu": flops / profile["peak_flops"],
        "hbm": hbm_bytes / profile["hbm_bw"],
        "ici": (ici_bytes / profile["ici_bw"]) if ici_bytes else 0.0,
    }
    bound = max(legs, key=lambda k: legs[k])
    wall_s = legs[bound]
    return {
        "wall_s": wall_s,
        "qps": (queries / wall_s) if wall_s > 0 else float("inf"),
        "bound": bound,
    }


# ---------------------------------------------------------------------------
# R8-cost over a recorded run (``analysis/rules.py`` wraps it)

COST_TOL_REL = 0.02
COST_TOL_ABS = 4096


def hbm_bytes(trace) -> int:
    """Bytes the run moves through device memory: every op that is not a
    view reads its inputs and writes its outputs once; a kernel moves
    what its side-band record declares."""
    from mpi_knn_tpu_torch.analysis.rules import VIEW_NAMES

    total = 0
    for op in trace.ops:
        if op.kind == "kernel":
            total += int(op.info.get("bytes", 0))
        elif op.name.split(".")[1] not in VIEW_NAMES:
            total += sum(t.nbytes for t in op.inputs + op.outputs)
    return total


def link_bytes(trace) -> int:
    """Bytes between ranks: the driver's copies, the sharded exchange and
    the kernels' own wire bytes."""
    return (sum(e.get("bytes", 0) for e in trace.events("send", "exchange"))
            + sum(int(k.info.get("wire_bytes", 0)) for k in trace.kernels()))


def cost_entry(trace, facts: dict, copies: int, profile_name: str) -> tuple:
    """(ledger entry, problems) of one cell."""
    counted = trace.counted_flops()
    analytical = analytical_mxu_flops(facts) * copies
    problems = []
    if counted != analytical:
        direction = ("does work the closed form cannot name"
                     if counted > analytical
                     else "lost a product the closed form prices")
        problems.append(
            f"counted product FLOPs {counted} != analytical {analytical} "
            f"({copies} × the facts {facts!r}) — the run {direction}")
    big = max(trace.products() + [k for k in trace.kernels() if k.flops],
              key=lambda o: o.flops, default=None)
    hbm, ici = hbm_bytes(trace), link_bytes(trace)
    queries = facts.get("queries", facts.get("q", 1))
    entry = {
        "mxu_flops": counted,
        "analytical_flops": analytical,
        "kernel_flops": sum(k.flops for k in trace.kernels()),
        "hbm_bytes": hbm,
        "ici_bytes": ici,
        "intensity": round(counted / hbm, 6) if hbm else 0.0,
        "queries": queries,
        "largest_product": None if big is None else {
            "flops": big.flops, "op": big.name, "index": big.index},
        "profile": profile_name,
        "roofline": roofline(counted, hbm, ici, queries,
                             get_profile(profile_name)),
    }
    return entry, problems


def r8_check(ctx, trace) -> list:
    """(message, evidence) pairs of R8; stashes the ledger entry in
    ``ctx.meta["r8_analysis"]``."""
    facts = ctx.meta.get("cost")
    if facts is None:
        return [("the cell declares no cost facts: its FLOPs cannot be "
                 "certified", {})]
    profile = ctx.meta.get("profile") or DEFAULT_PROFILE
    entry, problems = cost_entry(trace, facts, ctx.meta.get("cost_copies", 1),
                                 profile)
    ctx.meta["r8_analysis"] = entry
    return [(msg, {"mxu_flops": entry["mxu_flops"],
                   "analytical_flops": entry["analytical_flops"]})
            for msg in problems]


def _product_culprit(cell: dict) -> str:
    big = cell.get("largest_product") or {}
    return (f"largest product {big.get('flops')} FLOP {big.get('op')!r} at op "
            f"{big.get('index')}")


def _ledger_spec():
    from mpi_knn_tpu_torch.analysis import ledger

    return ledger.LedgerSpec(
        kind="cost", schema_version=1,
        source="mpi_knn_tpu_torch.analysis.cost",
        regen_cmd="python -m mpi_knn_tpu_torch lint --device cpu --cost",
        tol_rel=COST_TOL_REL, tol_abs=COST_TOL_ABS,
        metrics=(
            ledger.MetricSpec(key="mxu_flops", noun="product work",
                              unit="FLOPs", culprit=_product_culprit),
            ledger.MetricSpec(key="hbm_bytes", noun="memory traffic"),
            ledger.MetricSpec(key="ici_bytes", noun="link traffic"),
        ),
    )


LEDGER_SPEC = _ledger_spec()

"""Serving front end: the layer above ``ServeSession`` (the JAX package's
``frontend/``): request coalescing, SLO-aware admission, queue-driven
degradation, a thin multi-tenant HTTP shell with an open-loop load
generator, and the replicated tier.

Layout::

    coalesce.py    pure deterministic batcher (per-tenant FIFO, fill-or-
                   deadline formation, deadline-first round-robin drain)
    scheduler.py   SLO admission (queue-depth/rate 429s), overload
                   shed/recover wired to the resilience ladder
    server.py      the only impure parts: dispatch pump thread + stdlib
                   HTTP server (POST /query, /upsert, /delete, GET
                   /metrics, /healthz)
    loadgen.py     open-loop multi-tenant load generation (in-process
                   and HTTP transports, keep-alive connection pools,
                   multi-target), throughput-vs-p99 rows
    router.py      the replicated tier: health-gated membership,
                   tenant-affine (rendezvous) spread with least-queued
                   spill, sequenced mutation fan-out with bounded replay,
                   supervised replica spawning
    modelreplica.py torch-free deterministic-service stand-in replica
                   (the router's tests on hosts of few cores)
    cli.py         the ``serve`` / ``loadgen`` / ``router`` subcommands

Public surface::

    from mpi_knn_tpu_torch.frontend import (
        Coalescer, SLOPolicy, FrontendScheduler, Rejection,
        Frontend, FrontendHTTPServer, Ticket,
        Router, RouterPolicy, RouterHTTPServer, ReplicaSupervisor,
        Membership, MutationLog, ModelReplica, loadgen,
    )

Like ``resilience`` and ``obs``, the package is import-lazy (PEP 562)
and torch-free at module load: the pure machinery (coalescer, scheduler,
loadgen, router, model replica) runs in processes that never touch a
card; only a bound ``ServeSession`` brings torch with it.
"""

from __future__ import annotations

_EXPORTS = {
    "Coalescer": ("mpi_knn_tpu_torch.frontend.coalesce", "Coalescer"),
    "CoalescedBatch": ("mpi_knn_tpu_torch.frontend.coalesce", "CoalescedBatch"),
    "FrontendRequest": ("mpi_knn_tpu_torch.frontend.coalesce", "FrontendRequest"),
    "SLOPolicy": ("mpi_knn_tpu_torch.frontend.scheduler", "SLOPolicy"),
    "Rejection": ("mpi_knn_tpu_torch.frontend.scheduler", "Rejection"),
    "FrontendScheduler": (
        "mpi_knn_tpu_torch.frontend.scheduler", "FrontendScheduler"
    ),
    "Frontend": ("mpi_knn_tpu_torch.frontend.server", "Frontend"),
    "FrontendHTTPServer": (
        "mpi_knn_tpu_torch.frontend.server", "FrontendHTTPServer"
    ),
    "Ticket": ("mpi_knn_tpu_torch.frontend.server", "Ticket"),
    "Router": ("mpi_knn_tpu_torch.frontend.router", "Router"),
    "RouterPolicy": ("mpi_knn_tpu_torch.frontend.router", "RouterPolicy"),
    "RouterHTTPServer": (
        "mpi_knn_tpu_torch.frontend.router", "RouterHTTPServer"
    ),
    "ReplicaSupervisor": (
        "mpi_knn_tpu_torch.frontend.router", "ReplicaSupervisor"
    ),
    "Membership": ("mpi_knn_tpu_torch.frontend.router", "Membership"),
    "MutationLog": ("mpi_knn_tpu_torch.frontend.router", "MutationLog"),
    "ModelReplica": (
        "mpi_knn_tpu_torch.frontend.modelreplica", "ModelReplica"
    ),
    "loadgen": ("mpi_knn_tpu_torch.frontend", "loadgen"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    if name == "loadgen":
        return importlib.import_module("mpi_knn_tpu_torch.frontend.loadgen")
    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__

"""Host-side concurrency lint — lock discipline, lock ordering, thread
confinement, and atomic publication for the port's THREADED host modules
(the JAX package's ``analysis/host/``, with the port's own guard map).

An AST/call-graph static analyzer over the modules that carry the
serving stack's threads: the front end's dispatch pump and HTTP
handlers, the router and its replicas, the parallel warm pool, the
background compactor, concurrent kernel-cache writers, the process-wide
metrics registry and span recorder, the worker supervisor, and the
kernel libraries' builds. A latent race there silently corrupts the
counters, flight records and cache entries the verification story reads.

Rules (see ``rules.py``):

- **H1 lock discipline** — every shared mutable attribute of a
  thread-crossing class is declared in a per-class guard map, and every
  access site is statically inside a ``with <its-lock>:`` scope (or a
  declared-confined method); every call of a declared function
  (``engine.order_stream``) holds its lock. Undeclared attributes
  touched from two or more thread roots are findings.
- **H2 lock ordering** — the static lock-acquisition graph (nested
  ``with`` scopes propagated through the call graph, locks handed out by
  functions such as ``engine.mutation_lock`` included) must be acyclic.
- **H3 thread confinement** — attributes declared confined to one
  thread root must be unreachable from any other root's call graph.
- **H4 atomic publish** — file writes in threaded modules flow through
  the atomic temp+``os.replace`` helper (``utils.atomicio``) or carry
  their own ``os.replace``; a bare ``open(..., "w")`` is a finding.

Entry point: ``python -m mpi_knn_tpu_torch lint --host`` →
``artifacts/lint/torch/host_report.json`` (``engine.run_host_lint``
programmatically). ``witness.py`` is the runtime side, armed in tests
only.

Torch-free and import-light by construction: the analyzer reads source
text; it never imports the modules it checks. The names below load on
first use.
"""

from __future__ import annotations

_EXPORTS = {
    "HostReport": "mpi_knn_tpu_torch.analysis.host.engine",
    "run_host_lint": "mpi_knn_tpu_torch.analysis.host.engine",
    "ClassGuard": "mpi_knn_tpu_torch.analysis.host.guards",
    "GuardMap": "mpi_knn_tpu_torch.analysis.host.guards",
    "HostTarget": "mpi_knn_tpu_torch.analysis.host.guards",
    "default_guards": "mpi_knn_tpu_torch.analysis.host.guards",
    "default_targets": "mpi_knn_tpu_torch.analysis.host.guards",
    "HostFinding": "mpi_knn_tpu_torch.analysis.host.rules",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

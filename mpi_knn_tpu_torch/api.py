"""Public functional API of the port: ``all_knn``, ``knn_classify``, and
the serving entry points ``build_index`` / ``query_knn``.

Every entry point takes ``device=`` and runs on ``"cuda"`` unless the caller
passes ``"cpu"``; without a card the default raises (device.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.ops.vote import classify_from_labels
from mpi_knn_tpu_torch.types import ClassifyResult, KNNResult


def resolve_backend(cfg: KNNConfig, mesh=None, device=DEFAULT_DEVICE) -> str:
    """``auto`` is ``ring-overlap`` when the ring has more than one rank
    (``num_devices``, else the mesh, else the visible cards; the CPU counts
    one; a pod of processes always has more), else ``serial``, as in the
    JAX package."""
    from mpi_knn_tpu_torch.parallel import distributed

    if cfg.backend != "auto":
        return cfg.backend
    if distributed.process_count() > 1:
        n = distributed.process_count()
    elif cfg.num_devices is not None:
        n = cfg.num_devices
    elif mesh is not None:
        from mpi_knn_tpu_torch.parallel.mesh import mesh_size

        n = mesh_size(mesh)
    elif torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
    else:
        n = 1
    return "ring-overlap" if n > 1 else "serial"


def all_knn(corpus, queries=None, config: Optional[KNNConfig] = None,
            mesh=None, query_ids=None, device=DEFAULT_DEVICE,
            **overrides) -> KNNResult:
    """All-kNN search.

    Args:
      corpus: (m, d) numpy array or tensor.
      queries: (q, d) queries, or None for all-pairs leave-one-out mode
        (every corpus row queries the corpus with itself excluded).
      config: KNNConfig; fields may be overridden by kwargs.
      mesh: optional ring mesh for the ring backends: a list of devices,
        one per rank, or a (dp × ring) grid (``parallel/mesh.make_mesh2d``);
        default ``num_devices`` ranks.
      query_ids: optional (q,) corpus identities of explicit ``queries``
        (keeps self-exclusion for sampled corpus rows; -1 = none).
      device: where the search runs ("cuda" unless told otherwise).

    Returns:
      KNNResult with (q, k) distances (sortable space, ascending) and
      0-based int32 global ids, on ``device``.
    """
    cfg = (config or KNNConfig()).replace(**overrides)
    dev = resolve_device(device)
    backend = resolve_backend(cfg, mesh, dev)
    if isinstance(corpus, torch.Tensor):
        corpus = corpus.to(dev)
    else:
        corpus = np.asarray(corpus)
    m = corpus.shape[0]

    if queries is None:
        q_arr = corpus
        q_ids = np.arange(m, dtype=np.int32)
    else:
        if isinstance(queries, torch.Tensor):
            q_arr = queries.to(dev)
        elif isinstance(corpus, torch.Tensor):
            # host queries beside a tensor corpus go where the corpus is,
            # so centering subtracts one tensor mean from both
            q_arr = torch.as_tensor(np.asarray(queries), device=dev)
        else:
            q_arr = np.asarray(queries)
        if query_ids is not None:
            q_ids = np.asarray(query_ids, dtype=np.int32)
            if q_ids.shape != (q_arr.shape[0],):
                raise ValueError(
                    f"query_ids shape {q_ids.shape} != ({q_arr.shape[0]},)"
                )
        else:
            # -1 never matches a valid candidate id: self-exclusion is off
            q_ids = np.full(q_arr.shape[0], -1, dtype=np.int32)

    if cfg.center and cfg.metric == "l2":
        from mpi_knn_tpu_torch.ops.distance import center_for_l2

        corpus, q_arr = center_for_l2(corpus, q_arr, all_pairs=queries is None)

    if backend == "serial":
        from mpi_knn_tpu_torch.backends.serial import all_knn_serial

        d, i = all_knn_serial(corpus, q_arr, q_ids, cfg, dev)
    elif backend in ("ring", "ring-overlap"):
        from mpi_knn_tpu_torch.backends.ring import all_knn_ring

        d, i = all_knn_ring(corpus, q_arr, q_ids, cfg, mesh=mesh,
                            overlap=backend == "ring-overlap", device=dev)
    elif backend == "pallas":
        from mpi_knn_tpu_torch.backends.fused_backend import all_knn_pallas

        d, i = all_knn_pallas(corpus, q_arr, q_ids, cfg, dev)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return KNNResult(dists=d, ids=i)


def build_index(corpus, config: Optional[KNNConfig] = None,
                device=DEFAULT_DEVICE, mesh=None, **overrides):
    """Build a resident corpus index for query serving: every corpus-side
    step (centering mean, padding, the copy to the device, tiles, ids and
    norms, the kernels' staged planes, or the ring's shards) done once and
    reused by every :func:`query_knn` batch. See
    ``mpi_knn_tpu_torch.serve``."""
    from mpi_knn_tpu_torch.serve import build_index as _build

    return _build(corpus, config=config, device=device, mesh=mesh, **overrides)


def query_knn(queries, index, config: Optional[KNNConfig] = None,
              device=DEFAULT_DEVICE, **overrides) -> KNNResult:
    """Queries against a :func:`build_index` handle: the serving
    counterpart of ``all_knn(corpus, queries=...)``, equal to it bit for
    bit. Batches pad to power-of-two row buckets whose state is built once;
    results come back on the host with the padding stripped
    (``ServeSession`` streams batches with dispatch-ahead). A clustered
    index (``ivf.build_ivf_index`` / ``load_ivf_index``) serves through the
    same engine, equal bit for bit to its ``search_ivf``."""
    from mpi_knn_tpu_torch.serve import query_knn as _query

    return _query(queries, index, config=config, device=device, **overrides)


def knn_classify(result: KNNResult, labels, num_classes: int = 10,
                 tie_break: str = "nearest") -> ClassifyResult:
    """Majority-vote classification over a KNNResult, on its device."""
    labels = torch.as_tensor(labels, device=result.ids.device)
    return classify_from_labels(result.ids, labels, num_classes,
                                tie_break=tie_break)

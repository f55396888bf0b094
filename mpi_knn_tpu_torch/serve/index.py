"""Resident corpus index: the corpus-side half of query serving, done once
(the JAX package's ``serve/index.py``).

``all_knn(corpus, queries=batch)`` redoes every corpus-side step per call:
the f64 centering, padding, the host→device copy and, on the card, the
exact prologue over the whole corpus. ``CorpusIndex`` does them once:

- serial layout: the tile stack, its global ids and squared norms on the
  device (norms computed tile by tile, as ``knn_chunk_update`` does);
  ``bucket_headroom`` adds rows of id −1;
- pallas layout: the padded f32 corpus and, on a card, the prologue output
  its kernels read (``fused_knn.StagedCorpus``), staged at build for the
  build config: the TF32 hi/lo planes with their norms, or, where the
  config compresses (mixed), the bf16 copy with its norms. Each batch then
  stages its queries alone. A per-call config that needs the part not
  staged is refused;
- the centering mean, taken once as ``center_for_l2`` takes it (f64 on the
  host for a numpy corpus, the accumulation dtype for a tensor); batches
  are centered with it, so results equal a fresh ``all_knn`` bit for bit.

The per-(bucket, config) state of the engine lives in the index's
``_cache``, so two indices never share an entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.ops import fused_knn
from mpi_knn_tpu_torch.ops.distance import l2_mean
from mpi_knn_tpu_torch.ops.rerank import mixed_applies
from mpi_knn_tpu_torch.parallel.partition import (
    make_global_ids,
    pad_rows_any,
    pad_to_multiple,
)

SERVED_BACKENDS = ("serial", "pallas")


def canonical_device(device) -> torch.device:
    """``resolve_device``, with a card's index made explicit, so "cuda" and
    "cuda:0" name one index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def unported_backend_error(backend: str) -> ValueError:
    return ValueError(
        f"backend={backend!r}: serving over it is not yet ported to "
        "mpi_knn_tpu_torch (see ROADMAP.md); build the index with "
        "backend='serial' or 'pallas'"
    )


@dataclasses.dataclass
class CorpusIndex:
    """Resident corpus state for one (corpus, config, device). ``backend``
    is resolved (never "auto"); one of the two layouts is populated."""

    cfg: KNNConfig  # resolved backend; the serving default config
    backend: str
    m: int
    dim: int
    c_tile: int
    mu: object | None  # centering mean (host f64 or a tensor), or None
    device: torch.device
    # serial layout
    tiles: torch.Tensor | None = None  # (T, c_tile, d)
    tile_ids: torch.Tensor | None = None  # (T, c_tile)
    tile_sqs: torch.Tensor | None = None  # (T, c_tile)
    # pallas layout
    corpus_padded: torch.Tensor | None = None  # (c_pad, d) f32
    staged: fused_knn.StagedCorpus | None = None  # on a card only
    # the engine's per-(bucket, config) entries: {(bucket, cfg) -> _BucketExec}
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def nbytes_resident(self) -> int:
        """Bytes of the resident corpus state (tiles, ids and norms, or the
        padded corpus and its staged prologue outputs)."""
        parts = (self.tiles, self.tile_ids, self.tile_sqs, self.corpus_padded)
        return (sum(t.numel() * t.element_size() for t in parts
                    if t is not None)
                + (self.staged.nbytes if self.staged is not None else 0))

    def compatible_cfg(self, cfg: KNNConfig) -> KNNConfig:
        """Validate a per-query config against the build-time layout.

        Query-side knobs (k, topk method/block, merge schedule, precision
        policy, bucket/depth, tie break) may vary per call: the engine keys
        its entries on the full config. Corpus-side knobs are baked into
        the resident layout and may not vary."""
        frozen = (
            "backend", "metric", "dtype", "corpus_tile", "query_tile",
            "center", "mesh_axis", "num_devices", "ring_transfer_dtype",
            "ring_schedule", "max_tile_elems", "pallas_variant",
            "exclude_zero", "zero_eps",
        )
        built = self.cfg.replace(backend=self.backend)
        want = cfg if cfg.backend != "auto" else cfg.replace(
            backend=self.backend
        )
        bad = [f for f in frozen if getattr(want, f) != getattr(built, f)]
        if bad:
            raise ValueError(
                "query config changes corpus-side knobs baked into this "
                f"index: {bad}; build a new index (or override only "
                "query-side knobs: k/topk_method/merge_schedule/"
                "precision_policy/query_bucket/dispatch_depth/donate)"
            )
        if want.precision_policy == "mixed" and self.cfg.dtype != "float32":
            raise ValueError(
                "precision_policy='mixed' cannot serve from a "
                f"{self.cfg.dtype} index: the exact rerank contract is "
                "void on a corpus compressed at rest"
            )
        if self.staged is not None:
            compress = _compresses(want, self.c_tile)
            if (self.staged.compress if compress else self.staged.exact) is None:
                raise ValueError(
                    f"precision_policy={want.precision_policy!r} with "
                    f"k={want.k} reads the corpus's "
                    f"{'compress copy' if compress else 'exact planes'}, "
                    "which this index did not stage at build (built with "
                    f"precision_policy={self.cfg.precision_policy!r}, "
                    f"k={self.cfg.k}); build an index with that config"
                )
        return want


def _compresses(cfg: KNNConfig, c_tile: int) -> bool:
    return cfg.precision_policy == "mixed" and mixed_applies(cfg.k, c_tile)


def build_index(corpus, config: Optional[KNNConfig] = None,
                device=DEFAULT_DEVICE, **overrides) -> CorpusIndex:
    """Build a resident :class:`CorpusIndex` for query serving.

    Args:
      corpus: (m, d) numpy array or tensor (a tensor is indexed where it is
        moved to, without a host round trip).
      config: build-time :class:`KNNConfig`; kwargs override fields.
      device: where the index lives and its batches run ("cuda" unless
        told otherwise).
    """
    from mpi_knn_tpu_torch.api import resolve_backend

    cfg = (config or KNNConfig()).replace(**overrides)
    dev = canonical_device(device)
    backend = resolve_backend(cfg, device=dev)
    if backend not in SERVED_BACKENDS:
        raise unported_backend_error(backend)
    if isinstance(corpus, torch.Tensor):
        corpus = corpus.to(dev)
    else:
        corpus = np.asarray(corpus)
    m, dim = corpus.shape

    mu = None
    if cfg.center and cfg.metric == "l2":
        # the mean of center_for_l2, taken once; batches subtract it
        mu = l2_mean(corpus)
        corpus = corpus - mu
    cfg = cfg.replace(backend=backend)

    if backend == "pallas":
        from mpi_knn_tpu_torch.backends.fused_backend import fused_corpus_tile

        if cfg.dtype != "float32":
            raise ValueError(
                "pallas backend computes in float32; build the index with "
                f"dtype='float32' (got {cfg.dtype!r})"
            )
        if cfg.metric != "l2":
            raise ValueError(
                "pallas serving supports metric='l2' only: the cosine "
                "path needs a per-batch zero-row degeneracy probe (a "
                "host round-trip) that a streaming engine cannot honor — "
                "use the serial backend for cosine serving"
            )
        c_tile = fused_corpus_tile(cfg, m)
        corpus_p = pad_rows_any(corpus, pad_to_multiple(m, c_tile),
                                dtype=torch.float32, device=dev)
        staged = None
        if dev.type == "cuda":
            # the one part the build config's kernels read, staged once
            staged = fused_knn.stage_corpus(
                corpus_p, compress=_compresses(cfg, c_tile))
        return CorpusIndex(cfg=cfg, backend=backend, m=m, dim=dim,
                           c_tile=c_tile, mu=mu, device=dev,
                           corpus_padded=corpus_p, staged=staged)

    from mpi_knn_tpu_torch.backends.serial import (
        cap_corpus_tile,
        tile_sq_norms,
        torch_dtype,
    )

    c_tile = cap_corpus_tile(cfg.query_tile,
                             min(cfg.corpus_tile, pad_to_multiple(m, 128)),
                             cfg.max_tile_elems)
    # bucket_headroom: extra id −1 rows past the corpus (masked, never
    # answers), the reference's capacity for live upserts
    c_pad = pad_to_multiple(
        max(m, int(np.ceil(m * (1.0 + cfg.bucket_headroom)))), c_tile
    )
    tiles = pad_rows_any(corpus, c_pad, dtype=torch_dtype(cfg.dtype),
                         device=dev).reshape(-1, c_tile, dim)
    tile_ids = torch.from_numpy(
        make_global_ids(m, c_pad).reshape(-1, c_tile)).to(dev)
    return CorpusIndex(cfg=cfg, backend=backend, m=m, dim=dim, c_tile=c_tile,
                       mu=mu, device=dev, tiles=tiles, tile_ids=tile_ids,
                       tile_sqs=tile_sq_norms(tiles, cfg.metric))

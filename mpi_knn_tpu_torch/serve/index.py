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
  config compresses (mixed), the bf16 copy with its norms (at
  ``matmul_precision`` "default" / "high": the norms alone). Each batch then
  stages its queries alone. A per-call config that needs the part not
  staged is refused;
- ring layout (``ring``, ``ring-overlap``; the JAX package's
  ``serve/index.py:186-224``): the corpus padded by ``ring_tiles`` at the
  bucket base and sharded once over the P ranks of the mesh: per rank its
  block (int8 codes and scales when ``ring_transfer_dtype="int8"``,
  quantized once; bf16 rows on the bf16 wire), its ids, and, on the card,
  what the build config's ring form reads beside them (the norms for an
  exact fused merge, K4's planes with them on the dma form at "highest"),
  staged once. Batches rotate against these shards, which are only ever
  read;
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
from mpi_knn_tpu_torch.obs import spans as obs_spans
from mpi_knn_tpu_torch.ops import fused_knn
from mpi_knn_tpu_torch.ops.distance import l2_mean
from mpi_knn_tpu_torch.ops.rerank import mixed_applies
from mpi_knn_tpu_torch.parallel.partition import (
    make_global_ids,
    pad_rows_any,
    pad_to_multiple,
)
from mpi_knn_tpu_torch.shapes import serving_c_tile, serving_corpus_rows

SERVED_BACKENDS = ("serial", "pallas", "ring", "ring-overlap")


def canonical_device(device) -> torch.device:
    """``resolve_device``, with a card's index made explicit, so "cuda" and
    "cuda:0" name one index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
    # ring layout: the mesh, (q_axis, axis, dp, ring_n) as the JAX
    # package's, and per rank its traveler (block, ids, scale, norms, hi,
    # lo), staged once; ``ring_parts`` names the prologue outputs it holds
    mesh: list | None = None
    ring_meta: tuple | None = None
    shards: list | None = None
    ring_parts: tuple = ()
    # the engine's per-(bucket, config) entries: {(bucket, cfg) -> _BucketExec}
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def nbytes_resident(self) -> int:
        """Bytes of the resident corpus state (tiles, ids and norms, or the
        padded corpus and its staged prologue outputs)."""
        parts = [self.tiles, self.tile_ids, self.tile_sqs, self.corpus_padded]
        for shard in self.shards or ():
            parts += shard
        return (sum(t.numel() * t.element_size() for t in parts
                    if t is not None)
                + (self.staged.nbytes if self.staged is not None else 0))

    @property
    def live_rows(self) -> int:
        """Rows live now (not tombstoned) in the mutable serial layout, from
        the mutation freelist; ``m`` stays the build-time count."""
        from mpi_knn_tpu_torch.ivf.mutate import freelist_of

        if self.tiles is None:
            raise ValueError(
                f"the {self.backend!r} layout does not track liveness "
                "(only the serial tile stack is mutable)"
            )
        return freelist_of(self).live

    def compatible_cfg(self, cfg: KNNConfig) -> KNNConfig:
        """Validate a per-query config against the build-time layout.

        Query-side knobs (k, topk method/block, merge schedule, precision
        policy, bucket/depth, tie break) may vary per call: the engine keys
        its entries on the full config. Corpus-side knobs are baked into
        the resident layout and may not vary."""
        return self._check_cfg(cfg, staged=True)

    def stageable_cfg(self, cfg: KNNConfig) -> KNNConfig:
        """``compatible_cfg``, but a pallas config whose corpus prologue
        output the index has not staged yet passes: :meth:`stage_for`
        stages it (the degradation ladder's validation)."""
        return self._check_cfg(cfg, staged=False)

    def stage_for(self, cfg: KNNConfig) -> int:
        """Stage, once, the corpus prologue output the kernels of ``cfg``
        read, if this index has not (on a card, the pallas layout: the bf16
        copy a ``mixed`` rung reads beside an exact index's planes).
        Returns the resident bytes it added (0 off the card, or when
        already staged). It runs under the mutation lock and its stream
        joins the index's chain (``engine.order_stream``), so a later
        batch on any stream reads the part after it is written."""
        from mpi_knn_tpu_torch.serve.engine import mutation_lock, order_stream

        if self.staged is None:
            return 0
        compress = _compresses(cfg, self.c_tile)
        which = fused_knn.staged_part(compress, cfg.matmul_precision)
        if getattr(self.staged, which) is not None:
            return 0
        with mutation_lock(self):
            order_stream(self)
            part = fused_knn.stage_corpus(self.corpus_padded, compress=compress,
                                          precision=cfg.matmul_precision)
            setattr(self.staged, which, getattr(part, which))
        return part.nbytes

    def _check_cfg(self, cfg: KNNConfig, staged: bool) -> KNNConfig:
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
        if staged and self.staged is not None:
            which = fused_knn.staged_part(_compresses(want, self.c_tile),
                                          want.matmul_precision)
            if getattr(self.staged, which) is None:
                raise ValueError(
                    f"precision_policy={want.precision_policy!r} with "
                    f"k={want.k}, matmul_precision={want.matmul_precision!r} "
                    f"reads the corpus's {which} prologue output, which this "
                    "index did not stage at build (built with "
                    f"precision_policy={self.cfg.precision_policy!r}, "
                    f"k={self.cfg.k}, matmul_precision="
                    f"{self.cfg.matmul_precision!r}); build an index with "
                    "that config"
                )
        if self.shards is not None and self.device.type == "cuda":
            need = _ring_parts(want, self.mesh, self.c_tile, self.shards)
            if not set(need) <= set(self.ring_parts):
                raise ValueError(
                    f"this config's ring form reads the shards' {need}, but "
                    f"the index staged {self.ring_parts} at build; build an "
                    "index with that config"
                )
        return want


def _compresses(cfg: KNNConfig, c_tile: int) -> bool:
    return cfg.precision_policy == "mixed" and mixed_applies(cfg.k, c_tile)


def _ring_parts(cfg: KNNConfig, mesh, c_tile: int, shards) -> tuple:
    """The prologue outputs a ring of ``cfg`` reads beside each shard."""
    from mpi_knn_tpu_torch.backends.ring import ring_form, staged_parts

    return staged_parts(cfg, ring_form(cfg, mesh), c_tile, shards[0][0].dtype)


def _build_ring(corpus, cfg: KNNConfig, mesh, dev, backend, m, dim, mu):
    """The ring layout: the padded corpus sharded once over the mesh."""
    from mpi_knn_tpu_torch.backends.ring import (
        quantize_ring_block,
        ring_devices,
        ring_tiles,
        stage_travelers,
    )
    from mpi_knn_tpu_torch.backends.serial import torch_dtype
    from mpi_knn_tpu_torch.parallel.mesh import as_mesh2d, is_mesh2d

    if is_mesh2d(mesh) and backend == "ring":
        from mpi_knn_tpu_torch.backends.ring import (
            blocking_undefined_on_mesh_error,
        )

        raise blocking_undefined_on_mesh_error(as_mesh2d(mesh).axis_names)
    devices = ring_devices(cfg, mesh, dev)
    if any(canonical_device(d) != dev for d in devices):
        raise ValueError(
            f"a ring index on {dev} runs its ranks there: the mesh "
            f"{[str(d) for d in devices]} names another device (one card "
            "may hold every rank)")
    P = len(devices)
    # corpus-side padding only: the query side is the bucket's
    # (engine.ring_query_shapes); c_tile and c_pad as ring_tiles gives them
    _, c_tile, _, c_pad = ring_tiles(cfg, m, cfg.query_bucket, 1, P)
    corpus_p = pad_rows_any(corpus, c_pad, dtype=torch_dtype(cfg.dtype))
    ids = torch.from_numpy(make_global_ids(m, c_pad))
    scale = None
    if cfg.ring_transfer_dtype == "int8":
        # quantized once: the shards hold the wire's codes and scales
        corpus_p, scale = quantize_ring_block(corpus_p)
    elif cfg.ring_transfer_dtype is not None:
        corpus_p = corpus_p.to(torch_dtype(cfg.ring_transfer_dtype))
    b = c_pad // P
    raw = [(corpus_p[r * b:(r + 1) * b].to(d).contiguous(),
            ids[r * b:(r + 1) * b].to(d),
            None if scale is None else scale[r * b:(r + 1) * b].to(d).contiguous())
           for r, d in enumerate(devices)]
    parts = ()
    if dev.type == "cuda":  # the prologue outputs the build config's form reads
        parts = _ring_parts(cfg, devices, c_tile, raw)
    shards = stage_travelers(parts, raw)
    return CorpusIndex(cfg=cfg, backend=backend, m=m, dim=dim, c_tile=c_tile,
                       mu=mu, device=dev, mesh=devices,
                       ring_meta=(None, cfg.mesh_axis, 1, P), shards=shards,
                       ring_parts=parts)


def build_index(corpus, config: Optional[KNNConfig] = None,
                device=DEFAULT_DEVICE, mesh=None, **overrides) -> CorpusIndex:
    """Build a resident :class:`CorpusIndex` for query serving.

    Args:
      corpus: (m, d) numpy array or tensor (a tensor is indexed where it is
        moved to, without a host round trip).
      config: build-time :class:`KNNConfig`; kwargs override fields.
      device: where the index lives and its batches run ("cuda" unless
        told otherwise).
      mesh: the ring backends' ranks (``parallel/mesh.py``), all on
        ``device``; default ``num_devices`` ranks there.
    """
    from mpi_knn_tpu_torch.api import resolve_backend

    cfg = (config or KNNConfig()).replace(**overrides)
    dev = canonical_device(device)
    backend = resolve_backend(cfg, mesh, device=dev)
    if backend not in SERVED_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if not isinstance(corpus, torch.Tensor):
        corpus = np.asarray(corpus)
    with obs_spans.span("index-build", cat="index", backend=backend,
                        m=int(corpus.shape[0]), dim=int(corpus.shape[1])):
        return _build_index_resident(corpus, cfg, mesh, dev, backend)


def _build_index_resident(corpus, cfg: KNNConfig, mesh, dev,
                          backend: str) -> CorpusIndex:
    if backend == "ring" and cfg.ring_fusion == "fused":
        from mpi_knn_tpu_torch.backends.ring import fused_blocking_undefined_error

        raise fused_blocking_undefined_error()
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

    if backend in ("ring", "ring-overlap"):
        if mesh is None and cfg.num_devices is None and dev.type == "cuda":
            mesh = [dev]  # one card: one rank unless the config names more
        elif mesh is None and dev.type == "cuda":
            mesh = [dev] * cfg.num_devices
        return _build_ring(corpus, cfg, mesh, dev, backend, m, dim, mu)

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
                corpus_p, compress=_compresses(cfg, c_tile),
                precision=cfg.matmul_precision)
        return CorpusIndex(cfg=cfg, backend=backend, m=m, dim=dim,
                           c_tile=c_tile, mu=mu, device=dev,
                           corpus_padded=corpus_p, staged=staged)

    from mpi_knn_tpu_torch.backends.serial import tile_sq_norms, torch_dtype

    c_tile = serving_c_tile(cfg, m)
    # bucket_headroom: extra id −1 rows past the corpus (masked, never
    # answers), the reference's capacity for live upserts
    c_pad = serving_corpus_rows(m, cfg.bucket_headroom, c_tile)
    tiles = pad_rows_any(corpus, c_pad, dtype=torch_dtype(cfg.dtype),
                         device=dev).reshape(-1, c_tile, dim)
    tile_ids = torch.from_numpy(
        make_global_ids(m, c_pad).reshape(-1, c_tile)).to(dev)
    return CorpusIndex(cfg=cfg, backend=backend, m=m, dim=dim, c_tile=c_tile,
                       mu=mu, device=dev, tiles=tiles, tile_ids=tile_ids,
                       tile_sqs=tile_sq_norms(tiles, cfg.metric))

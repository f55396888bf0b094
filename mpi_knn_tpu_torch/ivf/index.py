"""Clustered (IVF) corpus index: k-means partitions, padded per-cluster
buckets, recall-targeted probe count (the JAX package's ``ivf/index.py``).

Layout, resident on the index's device after build:

- ``centroids (P, d)`` f32 and their squared norms, the routing table;
- ``buckets (P, bucket_cap, d)``: every partition's rows, padded to one
  ``bucket_cap`` (the largest cluster, times ``1 + bucket_headroom``,
  rounded up to 8); padding slots carry id −1 and are never answers. The
  rows are laid out by a stable sort of the assignments, so a cluster's
  rows keep their corpus order;
- ``bucket_ids (P, bucket_cap)`` int32 global ids;
- ``bucket_sqs (P, bucket_cap)`` squared norms of the rows AS STORED (the
  dequantized ones for a quantized store).

``dtype="bfloat16"`` halves the store; ``"int8"`` / ``"int4"`` keep
block-scaled codes (int4 two a lane) and a per-row f32 scale table
(``bucket_scales``), dequantized after the probe gather (``ops/quant.py``).

``nprobe=None`` at build tunes it: a held-out corpus sample is searched at
doubling, then bisected, nprobe and compared with ``nprobe == partitions``
(the exact full scan through the same search); the smallest nprobe that
reaches ``cfg.recall_target`` becomes the index default.

``save_ivf_index`` / ``load_ivf_index`` use the JAX package's ``.npz``
format, member for member (bf16 buckets as uint16 views, the config and
sizes as a JSON ``meta``), so an index saved by either package loads in
the other. A sharded index (``ivf/sharded.py``) saves its unsharded view,
so one file serves on any shard count (``shard_ivf_index`` after
``load_ivf_index``).
"""

from __future__ import annotations

import dataclasses
import io
import json
import warnings
from typing import Optional

import numpy as np
import torch

from mpi_knn_tpu_torch.backends.serial import torch_dtype
from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.ivf.kmeans import kmeans
from mpi_knn_tpu_torch.ivf.search import search_ivf
from mpi_knn_tpu_torch.ops.distance import sq_norms
from mpi_knn_tpu_torch.ops.quant import (
    QUANT_DTYPES,
    dequantize_rows,
    quantize_rows,
    row_wire_bytes,
)
from mpi_knn_tpu_torch.serve.index import canonical_device
from mpi_knn_tpu_torch.shapes import TUNE_SAMPLE, padded_bucket_cap
from mpi_knn_tpu_torch.utils.timing import PhaseTimer
IVF_DTYPES = ("float32", "bfloat16") + QUANT_DTYPES


@dataclasses.dataclass
class IVFIndex:
    """Resident clustered-index state for one (corpus, config, device).

    Serves through the engine of ``serve/engine.py`` as its ``"ivf"``
    route (``backend``, ``cfg``, ``mu``, ``m``, ``dim``, ``device``,
    ``_cache``, ``compatible_cfg``, ``nbytes_resident``)."""

    cfg: KNNConfig  # backend "serial", a concrete nprobe
    m: int
    dim: int
    partitions: int
    bucket_cap: int
    nprobe: int  # the index default (tuned or configured)
    mu: object | None  # centering mean (host f64), or None
    device: torch.device
    centroids: torch.Tensor  # (P, d) f32
    centroid_sqs: torch.Tensor  # (P,)
    buckets: torch.Tensor  # (P, cap, d) at rest; (P, cap, pd) int8 codes
    bucket_ids: torch.Tensor  # (P, cap) int32, -1 padding
    bucket_sqs: torch.Tensor  # (P, cap) f32
    bucket_scales: torch.Tensor | None = None  # (P, cap) f32, quantized only
    tuned_recall: float | None = None  # measured recall@k at ``nprobe``
    backend: str = "ivf"
    # seconds of the build's stages (kmeans, layout, quantize, tune)
    build_seconds: dict = dataclasses.field(default_factory=dict)
    # the engine's per-(bucket, config) entries
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def store_dtype(self) -> str:
        return self.cfg.dtype

    @property
    def live_rows(self) -> int:
        """Rows live now (not tombstoned), from the mutation freelist;
        ``m`` stays the build-time row count."""
        from mpi_knn_tpu_torch.ivf.mutate import freelist_of

        return freelist_of(self).live

    @property
    def nbytes_resident(self) -> int:
        """Bytes of the bucket store: rows or codes, plus the scale table
        of a quantized store."""
        n = self.buckets.numel() * self.buckets.element_size()
        if self.bucket_scales is not None:
            n += self.bucket_scales.numel() * self.bucket_scales.element_size()
        return n

    @property
    def probe_bytes(self) -> int:
        """Bytes one query row's probe gather reads at the default nprobe,
        priced at the store's width (codes plus scales when quantized)."""
        quant = self.store_dtype if self.store_dtype in QUANT_DTYPES else None
        return self.nprobe * self.bucket_cap * row_wire_bytes(
            self.dim, quant, self.buckets.element_size())

    def compatible_cfg(self, cfg: KNNConfig) -> KNNConfig:
        """Validate a per-query config against the trained partitions.

        Query-side knobs (k, nprobe, precision policy, tiling, bucket,
        depth) may vary per call; corpus-side knobs are baked into the
        partitions and may not. ``nprobe=None`` resolves to the index's
        default."""
        frozen = (
            "backend", "metric", "dtype", "partitions", "kmeans_iters",
            "kmeans_init", "ivf_seed", "center", "exclude_zero", "zero_eps",
            "bucket_headroom",
        )
        want = cfg if cfg.backend != "auto" else cfg.replace(backend="serial")
        bad = [f for f in frozen if getattr(want, f) != getattr(self.cfg, f)]
        if bad:
            raise ValueError(
                "query config changes corpus-side knobs baked into this "
                f"clustered index: {bad}; build a new index (or override "
                "only query-side knobs: k/nprobe/precision_policy/"
                "query_tile/query_bucket/dispatch_depth/donate)"
            )
        _refuse_inert_knobs(want)
        if want.nprobe is None:
            want = want.replace(nprobe=self.nprobe)
        return want


def _refuse_inert_knobs(cfg: KNNConfig) -> None:
    """Knobs the clustered search cannot honor are refused, never ignored:
    its finish is always the exact rerank top-k, and its products fix
    their own precisions."""
    if cfg.topk_method != "exact":
        raise ValueError(
            f"topk_method={cfg.topk_method!r} cannot be honored by the "
            "clustered (IVF) search: the probed-candidate finish is "
            "always the exact rerank top-k (ops/rerank.rerank_exact_topk)"
            " — unset it, or use a dense backend for approximate "
            "selection"
        )
    if cfg.matmul_precision is not None:
        raise ValueError(
            f"matmul_precision={cfg.matmul_precision!r} cannot be "
            "honored by the clustered (IVF) search: it fixes its own "
            "product precisions (full-f32 centroid score, exact rerank; "
            "bf16 compress under precision_policy='mixed')"
        )
    if cfg.merge_schedule != "twolevel":
        raise ValueError(
            f"merge_schedule={cfg.merge_schedule!r} cannot be honored by "
            "the clustered (IVF) search: there is no tile-merge schedule "
            "on the probed path (one gather, one exact finish) — leave "
            "it at the default"
        )


def _corpus_from_serve_index(serve_index):
    """Centered corpus rows (on the index's device) and mean back out of a
    serial-layout ``serve.CorpusIndex``."""
    if serve_index.tiles is None:
        raise ValueError(
            "an IVF index can only be built from a serial-layout "
            "CorpusIndex (tiles resident on one device); the "
            f"{serve_index.backend!r} layout shards or fuses the corpus"
        )
    rows = serve_index.tiles.reshape(-1, serve_index.dim)[:serve_index.m]
    mu = serve_index.mu
    if isinstance(mu, torch.Tensor):
        mu = mu.double().cpu().numpy()
    return rows.to(torch.float32), mu, serve_index.cfg


def build_ivf_index(corpus, config: Optional[KNNConfig] = None,
                    device=DEFAULT_DEVICE, **overrides) -> IVFIndex:
    """Train the k-means partitioner and build an :class:`IVFIndex` on
    ``device`` ("cuda" unless told otherwise).

    Args:
      corpus: (m, d) numpy array or tensor, or a serial-layout
        ``serve.CorpusIndex`` (its centered rows are reused).
      config: build-time :class:`KNNConfig` with ``partitions`` set;
        kwargs override fields. ``nprobe=None`` tunes nprobe. The k-means
        init draws from a ``torch.Generator`` on ``device`` seeded with
        ``cfg.ivf_seed``.
    """
    from mpi_knn_tpu_torch.serve.index import CorpusIndex

    cfg = (config or KNNConfig()).replace(**overrides)
    if cfg.partitions is None:
        raise ValueError(
            "building a clustered index requires partitions "
            "(KNNConfig.partitions / --partitions)"
        )
    if cfg.ivf_shards is not None:
        # trained here (the clustering does not depend on the layout),
        # then distributed over the ring mesh (ivf/sharded.py)
        from mpi_knn_tpu_torch.ivf.sharded import build_sharded_ivf_index

        return build_sharded_ivf_index(corpus, cfg, device=device)
    if cfg.backend not in ("auto", "serial"):
        raise ValueError(
            f"the clustered index is a single-device serial-math path; "
            f"backend={cfg.backend!r} cannot honor it (the pallas kernels "
            "and the ring rotation scan the full corpus by construction) "
            "— use backend='serial' or 'auto'"
        )
    if cfg.dtype not in IVF_DTYPES:
        raise ValueError(
            f"clustered index dtype must be one of {IVF_DTYPES} (float64 "
            f"is the dense backends' debug mode), got {cfg.dtype!r}"
        )
    _refuse_inert_knobs(cfg)
    cfg = cfg.replace(backend="serial")
    dev = canonical_device(device)

    mu = None
    if isinstance(corpus, CorpusIndex):
        X, mu, built_cfg = _corpus_from_serve_index(corpus)
        for f in ("metric", "dtype", "center"):
            if getattr(built_cfg, f) != getattr(cfg, f):
                raise ValueError(
                    f"IVF config {f}={getattr(cfg, f)!r} disagrees with "
                    f"the source CorpusIndex ({getattr(built_cfg, f)!r})"
                )
        X = X.to(dev)
    else:
        X = (corpus.detach().cpu().numpy() if isinstance(corpus, torch.Tensor)
             else np.asarray(corpus))
        X = X.astype(np.float32, copy=False)
        if cfg.center:
            mu = X.astype(np.float64).mean(axis=0)
            X = X - mu
        X = torch.from_numpy(np.ascontiguousarray(X)).to(dev, torch.float32)
    m, dim = X.shape
    if cfg.partitions > m:
        raise ValueError(
            f"partitions={cfg.partitions} exceeds the corpus rows ({m})"
        )
    P = cfg.partitions
    timer = PhaseTimer()

    with timer.phase("kmeans"):
        res = kmeans(X, P, iters=cfg.kmeans_iters, seed=cfg.ivf_seed,
                     init=cfg.kmeans_init, device=dev)
        timer.block_on(res.centroids, res.assignments)

    with timer.phase("layout"):
        assign = res.assignments.long()
        need = max(int(res.counts.max()), 1)
        cap = padded_bucket_cap(need, cfg.bucket_headroom)
        # rows by cluster, each row's slot its rank within its cluster
        order = torch.argsort(assign, stable=True)
        sa = assign[order]
        within = torch.arange(m, device=dev) - torch.searchsorted(sa, sa)
        buckets = X.new_zeros((P, cap, dim))
        buckets[sa, within] = X[order]
        bucket_ids = torch.full((P, cap), -1, dtype=torch.int32, device=dev)
        bucket_ids[sa, within] = order.to(torch.int32)
        timer.block_on(buckets, bucket_ids)

    with timer.phase("quantize"):
        bucket_scales = None
        if cfg.dtype in QUANT_DTYPES:
            # padding rows are zero: scale 0, codes 0; the norms are the
            # dequantized store's, so distances are exact w.r.t. what is
            # stored
            buckets, bucket_scales = quantize_rows(buckets, cfg.dtype)
            bucket_sqs = sq_norms(dequantize_rows(buckets, bucket_scales,
                                                  cfg.dtype, dim))
        else:
            buckets = buckets.to(torch_dtype(cfg.dtype))
            bucket_sqs = sq_norms(buckets)
        timer.block_on(buckets, bucket_sqs)

    index = IVFIndex(
        cfg=cfg, m=m, dim=dim, partitions=P, bucket_cap=cap,
        nprobe=cfg.nprobe or P, mu=mu, device=dev,
        centroids=res.centroids, centroid_sqs=sq_norms(res.centroids),
        buckets=buckets, bucket_ids=bucket_ids, bucket_sqs=bucket_sqs,
        bucket_scales=bucket_scales, build_seconds=timer.seconds,
    )
    with timer.phase("tune"):
        if cfg.nprobe is None:
            tuned, rec = tune_nprobe(index, cfg.recall_target, k=cfg.k)
            index.nprobe = tuned
            index.tuned_recall = rec
            index.cfg = cfg.replace(nprobe=tuned)
    return index


def tune_nprobe(index: IVFIndex, recall_target: float, k: int = 10,
                sample: int = TUNE_SAMPLE) -> tuple[int, float]:
    """Smallest nprobe whose recall@k on a held-out corpus sample reaches
    ``recall_target`` against ``nprobe == partitions`` through the same
    search (so the number is partition pruning's loss alone). The sample's
    rows come out of the bucket store (dequantized when quantized), with
    their ids, on the device. Returns (nprobe, measured recall)."""
    from mpi_knn_tpu_torch.utils.report import recall_at_k

    P = index.partitions
    ns = min(sample, index.m)
    rows = np.linspace(0, index.m - 1, num=ns, dtype=np.int64)
    flat_ids = index.bucket_ids.reshape(-1).cpu().numpy()
    pos_of = np.full(index.m, -1, dtype=np.int64)
    valid = flat_ids >= 0
    pos_of[flat_ids[valid]] = np.flatnonzero(valid)
    pos = torch.from_numpy(pos_of[rows]).to(index.device)
    Q = index.buckets.reshape(-1, index.buckets.shape[-1])[pos]
    if index.bucket_scales is not None:
        Q = dequantize_rows(Q, index.bucket_scales.reshape(-1)[pos],
                            index.store_dtype, index.dim)
    Q = Q.to(torch.float32)
    qids = rows.astype(np.int32)

    def search(n):
        _, ids = search_ivf(index, Q, query_ids=qids,
                            config=index.cfg.replace(nprobe=n, k=k),
                            assume_centered=True, device=index.device)
        return ids.cpu().numpy()

    want = search(P)
    lo, hi, hi_rec = 0, P, 1.0
    n = 1
    while n < P:
        rec = float(recall_at_k(search(n), want))
        if rec >= recall_target:
            hi, hi_rec = n, rec
            break
        lo = n
        n = min(2 * n, P)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        rec = float(recall_at_k(search(mid), want))
        if rec >= recall_target:
            hi, hi_rec = mid, rec
        else:
            lo = mid
    return hi, hi_rec


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_ivf_index(index: IVFIndex, path: str) -> str:
    """Write the whole index to one ``.npz`` in the JAX package's format
    (bf16 buckets as uint16 views), atomically. Returns the path. A
    sharded index saves its unsharded view: the file holds no layout."""
    from mpi_knn_tpu_torch.utils.atomicio import atomic_write_bytes

    if getattr(index, "backend", None) == "ivf-sharded":
        from mpi_knn_tpu_torch.ivf.sharded import unshard_ivf_index

        index = unshard_ivf_index(index)

    if not path.endswith(".npz"):
        path += ".npz"
    bf16 = index.buckets.dtype == torch.bfloat16
    buckets = (_host(index.buckets.view(torch.int16)).view(np.uint16) if bf16
               else _host(index.buckets))
    ids = _host(index.bucket_ids)
    meta = {
        "cfg": dataclasses.asdict(index.cfg),
        "m": index.m,
        "dim": index.dim,
        "partitions": index.partitions,
        "bucket_cap": index.bucket_cap,
        "nprobe": index.nprobe,
        "tuned_recall": index.tuned_recall,
        "buckets_bf16": bf16,
        "store_dtype": index.cfg.dtype,
        "has_mu": index.mu is not None,
        "live_rows": int((ids >= 0).sum()),
    }
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        centroids=_host(index.centroids),
        centroid_sqs=_host(index.centroid_sqs),
        buckets=buckets,
        bucket_ids=ids,
        bucket_sqs=_host(index.bucket_sqs),
        bucket_scales=(_host(index.bucket_scales)
                       if index.bucket_scales is not None
                       else np.zeros(0, np.float32)),
        mu=np.asarray(index.mu) if index.mu is not None else np.zeros(0),
    )
    atomic_write_bytes(path, buf.getvalue())
    return path


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A tensor of its own on ``dev`` from a (possibly read-only, mapped)
    array: the mapped pages are read once, by the copy."""
    with warnings.catch_warnings():
        # a read-only mapping: never written, copied below
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(arr)
    return t.to(dev, copy=True)


def load_ivf_index(path: str, mmap: bool = True,
                   device=DEFAULT_DEVICE) -> IVFIndex:
    """Reload a saved ``.npz`` (either package's) onto ``device``; the
    engine's entries start empty. ``mmap=True`` maps the archive's
    uncompressed members (``utils/npz_mmap``) so the disk read and the
    copy to the device are one pass; an archive the mapper cannot handle
    falls back to ``np.load`` with a ``RuntimeWarning``."""
    dev = canonical_device(device)
    z: dict | None = None
    if mmap:
        from mpi_knn_tpu_torch.utils.npz_mmap import mmap_npz

        try:
            z = mmap_npz(path)
        except ValueError as e:
            warnings.warn(
                f"cannot mmap index {path!r} ({e}); falling back to the "
                "copying np.load reader",
                RuntimeWarning,
                stacklevel=2,
            )
    if z is None:
        with np.load(path) as zf:
            z = {k: zf[k] for k in zf.files}
    meta = json.loads(bytes(np.asarray(z["meta"])).decode())
    cfg = KNNConfig(**meta["cfg"])
    if meta["buckets_bf16"]:
        buckets = _to_device(z["buckets"].view(np.int16), dev).view(
            torch.bfloat16)
    else:
        buckets = _to_device(z["buckets"], dev)
    store = meta.get("store_dtype", cfg.dtype)
    scales = None
    if store in QUANT_DTYPES:
        scales = _to_device(z["bucket_scales"], dev).reshape(
            meta["partitions"], meta["bucket_cap"])
    return IVFIndex(
        cfg=cfg,
        m=meta["m"],
        dim=meta["dim"],
        partitions=meta["partitions"],
        bucket_cap=meta["bucket_cap"],
        nprobe=meta["nprobe"],
        tuned_recall=meta["tuned_recall"],
        mu=np.array(z["mu"]) if meta["has_mu"] else None,
        device=dev,
        centroids=_to_device(z["centroids"], dev),
        centroid_sqs=_to_device(z["centroid_sqs"], dev),
        buckets=buckets,
        bucket_ids=_to_device(z["bucket_ids"], dev),
        bucket_sqs=_to_device(z["bucket_sqs"], dev),
        bucket_scales=scales,
    )

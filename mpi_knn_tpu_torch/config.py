"""Configuration of the PyTorch/CUDA port.

``KNNConfig`` carries the same field names and defaults as the JAX package's
config, so ``dataclasses.asdict`` of one drives the other (see
``convert.py``). The value domains and the cross-field rules are validated
the same way. On top of that, settings whose machinery is not ported yet
are refused here with a ``ValueError`` that names the setting and says "not
yet ported" — a refused setting never silently runs as something else.

Fields that only the sharded clustered index reads (``ivf_shards``,
``ivf_route_cap``) are kept so a config dict round-trips; ``ivf_shards``
is refused until that layer is ported. The live-mutation fields
(``bucket_headroom``, ``mutation_bucket``, ``compact_fill_threshold``,
``compact_tombstone_fraction``) are read by ``serve/mutate.py`` and
``ivf/mutate.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# "pallas" keeps the JAX package's name for the fused backend; in this port
# it selects the hand-written Hopper kernels (backends/fused_backend.py)
BACKENDS = ("auto", "serial", "ring", "ring-overlap", "pallas")
METRICS = ("l2", "cosine")
RING_TRANSFER_DTYPES = (None, "bfloat16", "float32", "int8")
TOPK_METHODS = ("exact", "approx", "approx-rerank", "block", "bf16")
PRECISION_POLICIES = ("exact", "mixed")
MERGE_SCHEDULES = ("stream", "twolevel")
RING_SCHEDULES = ("uni", "bidir")
RING_FUSIONS = ("xla", "fused")
RING_FUSED_ROTATIONS = ("round", "grid")
TIE_BREAKS = ("nearest", "lowest", "quirk-serial", "quirk-mpi")
PALLAS_VARIANTS = ("tiles", "sweep")
KMEANS_INITS = ("kmeans++", "random")
DTYPES = ("float32", "float64", "bfloat16", "int8", "int4")

MATMUL_PRECISIONS = (None, "default", "high", "highest")


@dataclasses.dataclass(frozen=True)
class KNNConfig:
    """All knobs for an all-kNN run (field docs: the JAX package's
    ``mpi_knn_tpu/config.py``; semantics are identical where ported).

    Ported: k, metric, backend (all five), query_tile, corpus_tile, dtype
    in {float32, float64, bfloat16}, matmul_precision (None and "highest":
    f32-accurate products, torch.matmul in full f32 and on the card the
    kernels' three-pass TF32 tile; "default": f32 operands rounded to bf16,
    one pass; "high": bf16 hi + lo, three passes; f64 and bf16 operands
    keep their products), precision_policy, center, exclude_self,
    exclude_zero, zero_eps, topk_method (all five, the approximate ones on
    f32 and f64 distances), recall_target, topk_block, merge_schedule,
    tie_break, num_classes, mesh_axis, num_devices, ring_transfer_dtype,
    ring_schedule, ring_fusion, ring_fused_rotation, pallas_variant,
    max_tile_elems, the serving fields, and the clustered index's
    (``ivf/``): partitions, nprobe, kmeans_iters, kmeans_init, ivf_seed,
    bucket_headroom and dtype int8 / int4 at rest, and live mutation's
    (``serve/mutate.py``): mutation_bucket, compact_fill_threshold,
    compact_tombstone_fraction. ``ivf_shards`` (the sharded clustered
    index) is refused.
    """

    k: int = 30
    metric: str = "l2"
    backend: str = "auto"
    query_tile: int = 1024
    corpus_tile: int = 2048
    dtype: str = "float32"
    matmul_precision: Optional[str] = None
    precision_policy: str = "exact"
    center: bool = True
    exclude_self: bool = True
    exclude_zero: bool = True
    zero_eps: float = 0.0
    topk_method: str = "exact"
    recall_target: float = 0.95
    topk_block: int = 128
    merge_schedule: str = "twolevel"
    tie_break: str = "nearest"
    num_classes: int = 10
    mesh_axis: str = "ring"
    num_devices: Optional[int] = None
    ring_transfer_dtype: Optional[str] = None
    ring_schedule: str = "uni"
    ring_fusion: str = "xla"
    ring_fused_rotation: str = "round"
    pallas_variant: str = "tiles"
    max_tile_elems: int = 1 << 28
    # --- serving, the clustered index and live mutation (the sharded
    # index's fields: refused or unread until ported) ---
    query_bucket: int = 1024
    dispatch_depth: int = 2
    partitions: Optional[int] = None
    nprobe: Optional[int] = None
    kmeans_iters: int = 25
    kmeans_init: str = "kmeans++"
    ivf_seed: int = 0
    ivf_shards: Optional[int] = None
    ivf_route_cap: Optional[int] = None
    bucket_headroom: float = 0.0
    mutation_bucket: int = 256
    compact_fill_threshold: float = 0.9
    compact_tombstone_fraction: float = 0.3
    donate: bool = True

    def __post_init__(self):
        for name, allowed in (
            ("backend", BACKENDS),
            ("metric", METRICS),
            ("topk_method", TOPK_METHODS),
            ("tie_break", TIE_BREAKS),
            ("pallas_variant", PALLAS_VARIANTS),
            ("ring_transfer_dtype", RING_TRANSFER_DTYPES),
            ("ring_schedule", RING_SCHEDULES),
            ("ring_fusion", RING_FUSIONS),
            ("ring_fused_rotation", RING_FUSED_ROTATIONS),
            ("merge_schedule", MERGE_SCHEDULES),
            ("precision_policy", PRECISION_POLICIES),
            ("kmeans_init", KMEANS_INITS),
            ("dtype", DTYPES),
            ("matmul_precision", MATMUL_PRECISIONS),
        ):
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        for name in ("k", "topk_block", "query_bucket", "dispatch_depth",
                     "mutation_bucket", "kmeans_iters"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.dtype in ("int8", "int4") and self.partitions is None:
            raise ValueError(
                f"dtype={self.dtype!r} is the clustered index's at-rest "
                "compression; the dense backends have no dequantization path"
            )
        self._check_cross_fields()
        self._check_index_fields()
        self._refuse_unported()

    def _check_cross_fields(self):
        """The JAX package's cross-field rules, with the same meaning."""
        if self.ring_transfer_dtype == "int8" and self.precision_policy != "mixed":
            raise ValueError(
                "ring_transfer_dtype='int8' requires precision_policy="
                "'mixed': only the exact rerank absorbs the quantization "
                f"noise (got precision_policy={self.precision_policy!r})"
            )
        if self.ring_fusion == "fused":
            if self.metric != "l2":
                raise ValueError(
                    "ring_fusion='fused' supports metric='l2' only (got "
                    f"metric={self.metric!r})"
                )
            if self.dtype != "float32":
                raise ValueError(
                    "ring_fusion='fused' requires dtype='float32'; compress "
                    "the wire with ring_transfer_dtype instead (got "
                    f"dtype={self.dtype!r})"
                )
            if self.topk_method != "exact":
                raise ValueError(
                    "ring_fusion='fused' requires topk_method='exact': the "
                    "in-kernel carry merge is exact (got "
                    f"{self.topk_method!r})"
                )
            if (self.ring_fused_rotation == "grid"
                    and self.ring_transfer_dtype == "int8"):
                raise ValueError(
                    "ring_fused_rotation='grid' supports float wire "
                    "formats only (float32/bfloat16): the grid kernel "
                    "DMAs raw slot bytes between its HBM double-buffer "
                    "slots and casts them straight into the distance dot "
                    "— int8 codes would be cast without dequantization "
                    "(the scale plumbing belongs to the round form)"
                )
            if self.ring_fused_rotation == "grid" and (
                    self.ring_schedule != "uni"
                    or self.precision_policy != "exact"):
                raise ValueError(
                    "ring_fused_rotation='grid' (whole-rotation single "
                    "launch) supports ring_schedule='uni' with "
                    "precision_policy='exact' only: bidir needs two "
                    "opposed DMA streams per round and mixed needs the "
                    "XLA rerank between rounds — got schedule="
                    f"{self.ring_schedule!r}, policy="
                    f"{self.precision_policy!r}"
                )
        if self.precision_policy == "mixed":
            if self.dtype not in ("float32", "int8", "int4"):
                raise ValueError(
                    "precision_policy='mixed' requires dtype='float32' (got "
                    f"{self.dtype!r})"
                )
            if self.matmul_precision is not None:
                raise ValueError(
                    "precision_policy='mixed' owns both dot precisions; "
                    "matmul_precision must be None, got "
                    f"{self.matmul_precision!r}"
                )

    def _check_index_fields(self):
        """The JAX package's rules for the serving and clustered-index
        fields (``mpi_knn_tpu/config.py:457-522``): a setting the reference
        refuses is refused here too."""
        if self.partitions is not None and self.partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {self.partitions}")
        if self.nprobe is not None:
            if self.partitions is None:
                raise ValueError(
                    "nprobe without partitions is meaningless: nprobe "
                    "selects how many of the clustered index's partitions "
                    "to scan — set partitions too"
                )
            if not 1 <= self.nprobe <= self.partitions:
                raise ValueError(
                    f"nprobe must be in [1, partitions={self.partitions}], "
                    f"got {self.nprobe}"
                )
        if self.partitions is not None and self.metric != "l2":
            raise ValueError(
                "a clustered (IVF) index supports metric='l2' only (got "
                f"metric={self.metric!r})"
            )
        if self.ivf_shards is not None:
            if self.partitions is None:
                raise ValueError(
                    "ivf_shards without partitions is meaningless: sharding "
                    "distributes a clustered index's partition buckets — "
                    "set partitions too"
                )
            if self.ivf_shards < 1:
                raise ValueError(f"ivf_shards must be >= 1, got {self.ivf_shards}")
        if self.ivf_route_cap is not None:
            if self.ivf_shards is None:
                raise ValueError(
                    "ivf_route_cap without ivf_shards is meaningless: the "
                    "route cap bounds the sharded candidate exchange"
                )
            if self.ivf_route_cap < 1:
                raise ValueError(
                    f"ivf_route_cap must be >= 1, got {self.ivf_route_cap}"
                )
        if not self.bucket_headroom >= 0.0:
            raise ValueError(
                f"bucket_headroom must be >= 0, got {self.bucket_headroom}"
            )
        if not 0.0 < self.compact_fill_threshold <= 1.0:
            raise ValueError(
                "compact_fill_threshold must be in (0, 1], got "
                f"{self.compact_fill_threshold}"
            )
        if not self.compact_tombstone_fraction > 0.0:
            raise ValueError(
                "compact_tombstone_fraction must be > 0, got "
                f"{self.compact_tombstone_fraction}"
            )

    def _refuse_unported(self):
        if self.ivf_shards is not None:
            raise ValueError(
                f"ivf_shards={self.ivf_shards!r}: not yet ported to "
                "mpi_knn_tpu_torch (see ROADMAP.md)"
            )

    def replace(self, **kw) -> KNNConfig:
        return dataclasses.replace(self, **kw)

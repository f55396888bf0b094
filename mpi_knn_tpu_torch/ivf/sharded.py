"""Sharded clustered (IVF) index: the bucket store distributed over the
ring mesh with a routed candidate exchange (the JAX package's
``ivf/sharded.py``), run by one controlling process.

Layout (derived, never stored: one saved index serves on any shard
count):

- the ``(P, d)`` centroid table and its norms are replicated on every
  device of the mesh, so every shard scores its own queries;
- the padded bucket store ``(P, cap, ·)`` with its ids, norms and (int8 /
  int4) scales is cut into contiguous slices of ``ceil(P / S)`` clusters
  a shard: cluster ``c`` lives on shard ``c // per_shard`` at local slot
  ``c % per_shard``; the last shard's padding clusters carry id −1 rows
  and no route reaches them (the routing table has only P real rows);
- a batch's query tiles are cut over the same shards in contiguous runs:
  each shard is the home of its tiles.

When every rank of the mesh is one device (a card named S times, or S
logical ranks on the CPU), the store stays one set of tensors there and
each shard's slice is a view of it; the mutation path (``ivf/mutate.py``,
``serve/mutate.py``) then writes the store in place, as for the
unsharded index, with a freelist whose sentinel is the store's total
bucket count. Over distinct cards each slice lives on its own card, and
the store is not mutable.

Routed two-stage search, per tile step (every shard's j-th tile at once):

1. **score at home**: each shard scores the centroids for its tile
   (``ivf/search.score_centroids``) → ``(q_tile, nprobe)`` partitions;
2. **request exchange**: each (query, probe) pair is a route to the owning
   shard, ranked probe-rank-major (every query's rank-0 probe before any
   query's rank-1 probe, so a tight cap is spent on the best probes) and
   padded to the static per-(home, owner) ``route_cap`` (−1: empty; ranks
   past the cap are dropped and counted, never sent wrong). The reference's
   ``all_to_all`` becomes a request table per (home, owner) pair moved with
   ``Tensor.to`` onto the owner's device;
3. **candidate exchange**: each owner gathers the requested buckets from
   its slice at the store's width (int8 / int4 codes and their scales) and
   each (owner, home) tile moves back to the home's device. Ranks that
   share a device move no bytes; the shapes are the reference's all the
   same;
4. **finish at home**: the candidates are laid out as ``(q_tile,
   nprobe·cap, ·)`` in exactly the order the unsharded gather gives,
   dequantized there, and finished by the shared
   ``ivf/search.finish_candidates``: the mixed policy composes, S = 1 is
   bit for bit the unsharded index, and at equal nprobe every S returns
   the unsharded index's results.

Per-shard stats, summed over a batch's tiles: ``[routed, dropped,
served]`` (routes this shard's queries issued and kept, routes dropped at
the cap, real requests this shard answered as owner). A query whose every
probe was dropped retires all +inf with ids −1: a counted loss.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.ivf.index import IVFIndex, _refuse_inert_knobs
from mpi_knn_tpu_torch.ivf.search import finish_candidates, score_centroids
from mpi_knn_tpu_torch.ops.distance import center_rows
from mpi_knn_tpu_torch.ops.quant import QUANT_DTYPES, dequantize_rows, row_wire_bytes
from mpi_knn_tpu_torch.parallel.mesh import RingMesh, make_ring_mesh
from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple

# per-shard exchange stats: routes this shard's queries issued and kept,
# routes dropped at the cap, real requests this shard answered as owner
STATS_FIELDS = ("routed", "dropped", "served")
N_STATS = len(STATS_FIELDS)


def resolve_route_cap(cfg: KNNConfig, q_tile: int, nprobe: int) -> int:
    """The static per-(home, owner) route capacity of one query tile:
    ``cfg.ivf_route_cap`` clamped to the safe cap ``q_tile·nprobe``, or the
    safe cap itself when unset (no probe can drop)."""
    safe = max(1, q_tile * nprobe)
    if cfg.ivf_route_cap is None:
        return safe
    return min(cfg.ivf_route_cap, safe)


def exchange_elems(shards: int, route_cap: int, cap: int, dim: int) -> int:
    """Elements of one tile's largest exchange buffer, the (S, route_cap,
    cap, d) candidate rows."""
    return shards * route_cap * cap * dim


def exchange_bytes_per_tile(shards: int, route_cap: int, cap: int, dim: int,
                            itemsize: int, scale_bytes: int = 0) -> int:
    """Bytes one query tile's exchange moves a shard: the int32 request
    table, then per route the rows at the store's width (a quantized
    store's packed code lanes at itemsize 1), ids (int32), norms (f32) and
    ``scale_bytes`` (4 for a quantized store's per-row scale)."""
    per_route = 4 + cap * (dim * itemsize + 4 + 4 + scale_bytes)
    return shards * route_cap * per_route


def exchange_wire_args(index) -> tuple[int, int, int]:
    """(lanes, itemsize, scale_bytes) of one candidate row on the exchange
    for ``index``'s store."""
    if getattr(index, "store_dtype", None) in QUANT_DTYPES:
        return index.slices[0][0].shape[-1], 1, 4
    return index.dim, index.slices[0][0].element_size(), 0


def sharded_query_shapes(cfg: KNNConfig, nprobe: int, bucket_cap: int,
                         dim: int, nq: int, shards: int) -> tuple[int, int, int]:
    """(q_tile, q_pad, route_cap) of a sharded batch: q_tile halves until
    both one tile's finish (q_tile·nprobe·cap·d) and its exchange buffer
    (S·route_cap·cap·d) fit ``cfg.max_tile_elems``; q_pad is a multiple of
    S·q_tile, so every shard holds as many whole tiles."""
    per_row = max(1, nprobe * bucket_cap * dim)
    q_tile = min(cfg.query_tile, pad_to_multiple(max(1, -(-nq // shards)), 8))

    def biggest(qt: int) -> int:
        rc = resolve_route_cap(cfg, qt, nprobe)
        return max(qt * per_row, exchange_elems(shards, rc, bucket_cap, dim))

    while q_tile > 1 and biggest(q_tile) > cfg.max_tile_elems:
        q_tile = max(1, q_tile // 2)
    if biggest(q_tile) > cfg.max_tile_elems:
        raise ValueError(
            f"one sharded query tile's working set ({biggest(q_tile)} "
            f"elems: nprobe={nprobe} × bucket_cap={bucket_cap} × d={dim} "
            f"per row, exchanged over {shards} shards) exceeds "
            f"max_tile_elems={cfg.max_tile_elems}; lower nprobe/"
            "partitions, set a smaller ivf_route_cap, raise "
            "max_tile_elems, or serve unsharded"
        )
    q_pad = pad_to_multiple(nq, shards * q_tile)
    return q_tile, q_pad, resolve_route_cap(cfg, q_tile, nprobe)


def _routes(probe, per_shard: int, shards: int, route_cap: int):
    """A home tile's routes in priority order (route t = j·q_tile + q, probe
    rank major): owner, rank at the owner, dropped, local slot, and the
    (S, route_cap) request table (−1: empty)."""
    n = probe.numel()
    flat_t = probe.T.reshape(n)
    dest_t = flat_t // per_shard
    slot_t = (flat_t % per_shard).to(torch.int32)
    # each route's rank in its owner's list, by a cumulative sum over a
    # one-hot: deterministic and stable
    onehot = (dest_t[:, None] == torch.arange(shards, device=probe.device)
              ).to(torch.int32)
    rank_t = (torch.cumsum(onehot, 0) - 1).gather(1, dest_t[:, None])[:, 0]
    dropped_t = rank_t >= route_cap
    req = torch.full((shards, route_cap), -1, dtype=torch.int32,
                     device=probe.device)
    keep = ~dropped_t
    req.index_put_((dest_t[keep], rank_t[keep].long()), slot_t[keep])
    return dest_t, rank_t, dropped_t, req


def routed_query_tile(q_x, q_ids, centroids, slices, cfg: KNNConfig,
                      nprobe: int, route_cap: int, devices):
    """One tile step through the routed two-stage search: shard h's tile
    ``q_x[h]`` (its ``q_ids[h]``) on ``devices[h]``, the centroid replicas
    ``centroids[h]`` = (table, norms), and every shard's store slice
    ``slices[o]`` = (buckets, ids, norms, scales or None). Returns per home
    shard ((q_tile, k) dists, ids) and the (S, N_STATS) int64 stats on
    ``devices[0]``."""
    shards = len(slices)
    per_shard, cap = slices[0][0].shape[:2]
    homes, req = [], []
    for h in range(shards):
        qx = q_x[h].to(torch.float32)
        q_sq, probe = score_centroids(qx, *centroids[h], nprobe)
        dest_t, rank_t, dropped_t, r = _routes(probe, per_shard, shards,
                                               route_cap)
        homes.append((qx, q_sq, dest_t, rank_t, dropped_t))
        req.append(r)

    # owner side: the requests from every home, then the requested buckets
    # gathered from the slice at rest (an empty slot gathers slot 0, its
    # ids forced to −1)
    returned, served = [], []
    for o in range(shards):
        dev = devices[o]
        req_in = torch.stack([req[h][o].to(dev) for h in range(shards)])
        buckets, bids, bsqs, bscl = slices[o]
        take = req_in.clamp(0, per_shard - 1).long()
        empty = (req_in < 0)[..., None]
        returned.append((buckets[take],
                         torch.where(empty, -1, bids[take]),
                         bsqs[take],
                         None if bscl is None else bscl[take]))
        served.append((req_in >= 0).sum())

    out, stats = [], []
    for h in range(shards):
        qx, q_sq, dest_t, rank_t, dropped_t = homes[h]
        dev = devices[h]
        qt = qx.shape[0]
        n = qt * nprobe
        # the home's candidates in query-major probe order (the unsharded
        # gather's layout): f = q·nprobe + j is route t = j·q_tile + q
        f = torch.arange(n, device=dev)
        t_of = (f % nprobe) * qt + f // nprobe
        dest, rank, dropped = dest_t[t_of], rank_t[t_of], dropped_t[t_of]
        src = dest * route_cap + rank.clamp(max=route_cap - 1)

        def home_tile(part):
            return torch.cat([returned[o][part][h].to(dev) for o in range(shards)])

        v = nprobe * cap
        rows = home_tile(0)[src]
        rows = rows.reshape(qt, v, rows.shape[-1])
        ids = torch.where(dropped[:, None], -1, home_tile(1)[src]).reshape(qt, v)
        sqs = home_tile(2)[src].reshape(qt, v)
        if returned[0][3] is not None:
            # dequantized at home, after the exchange moved the codes
            rows = dequantize_rows(rows, home_tile(3)[src].reshape(qt, v),
                                   cfg.dtype, qx.shape[1])
        out.append(finish_candidates(qx, q_ids[h], q_sq, rows.to(torch.float32),
                                     ids, sqs, cfg))
        stats.append(torch.stack([(~dropped).sum(), dropped.sum(),
                                  served[h].to(dev)]).to(devices[0]))
    return out, torch.stack(stats)


# ---------------------------------------------------------------------------
# The resident sharded index


def _one_device(mesh) -> bool:
    return len({str(d) for d in mesh}) == 1


@dataclasses.dataclass
class ShardedIVFIndex:
    """Mesh-resident sharded clustered index. It serves through the
    engine's ``"ivf-sharded"`` route (``backend``, ``cfg``, ``mu``, ``m``,
    ``dim``, ``device``, ``_cache``, ``compatible_cfg``,
    ``nbytes_resident``); ``device`` is the mesh's first, where a batch is
    staged and its results gathered.

    On one device, ``buckets`` / ``bucket_ids`` / ``bucket_sqs`` /
    ``bucket_scales`` are the whole store ``(S·per_shard, cap, ·)`` and
    ``slices`` views of it; over distinct cards they are None and
    ``slices`` holds each shard's tensors on its card."""

    cfg: KNNConfig  # backend "serial", a concrete nprobe, ivf_shards set
    m: int
    dim: int
    partitions: int
    bucket_cap: int
    nprobe: int
    mu: object | None
    shards: int
    per_shard: int  # clusters a shard, padding clusters included
    mesh: RingMesh
    device: torch.device
    centroids: torch.Tensor  # (P, d) f32 on ``device``
    centroid_sqs: torch.Tensor
    buckets: torch.Tensor | None
    bucket_ids: torch.Tensor | None
    bucket_sqs: torch.Tensor | None
    bucket_scales: torch.Tensor | None = None
    tuned_recall: float | None = None
    backend: str = "ivf-sharded"
    build_seconds: dict = dataclasses.field(default_factory=dict)
    # over distinct cards: per shard (buckets, ids, sqs, scales) on its card
    shard_store: list | None = None
    # per distinct device of the mesh but ``device``: (centroids, norms)
    replicas: dict = dataclasses.field(default_factory=dict)
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def store_dtype(self) -> str:
        return self.cfg.dtype

    @property
    def slices(self) -> list:
        """Per shard (buckets, ids, sqs, scales or None): views of the one
        store (taken anew, so a compaction's swapped store is seen), or
        the shards' own tensors over distinct cards."""
        if self.shard_store is not None:
            return self.shard_store
        p = self.per_shard
        return [tuple(None if t is None else t[s * p:(s + 1) * p]
                      for t in (self.buckets, self.bucket_ids,
                                self.bucket_sqs, self.bucket_scales))
                for s in range(self.shards)]

    def centroid_replica(self, device) -> tuple:
        """(centroids, norms) on ``device``."""
        dev = torch.device(device)
        if dev == self.device:
            return self.centroids, self.centroid_sqs
        return self.replicas[str(dev)]

    @property
    def live_rows(self) -> int:
        from mpi_knn_tpu_torch.ivf.mutate import freelist_of

        return freelist_of(self).live

    @property
    def nbytes_resident(self) -> int:
        """Bytes of the store over every shard (padding clusters and a
        quantized store's scales included)."""
        return sum(t.numel() * t.element_size()
                   for s in self.slices for t in (s[0], s[3]) if t is not None)

    @property
    def shard_nbytes_resident(self) -> int:
        """Bytes of one shard's slice."""
        return self.nbytes_resident // self.shards

    @property
    def probe_bytes(self) -> int:
        """Bytes one query row's probes touch at the default nprobe, at the
        store's width (the unsharded bound: the same buckets move)."""
        quant = self.store_dtype if self.store_dtype in QUANT_DTYPES else None
        return self.nprobe * self.bucket_cap * row_wire_bytes(
            self.dim, quant, self.slices[0][0].element_size())

    def compatible_cfg(self, cfg: KNNConfig) -> KNNConfig:
        """The unsharded index's corpus-side freeze plus ``ivf_shards``
        (the layout is derived from it); ``ivf_route_cap`` is query-side:
        it shapes the exchange only, and entries key on the whole
        config."""
        frozen = (
            "backend", "metric", "dtype", "partitions", "kmeans_iters",
            "kmeans_init", "ivf_seed", "center", "exclude_zero", "zero_eps",
            "ivf_shards", "bucket_headroom",
        )
        want = cfg if cfg.backend != "auto" else cfg.replace(backend="serial")
        bad = [f for f in frozen if getattr(want, f) != getattr(self.cfg, f)]
        if bad:
            raise ValueError(
                "query config changes corpus-side knobs baked into this "
                f"sharded clustered index: {bad}; build (or re-shard) a new "
                "index, or override only query-side knobs: k/nprobe/"
                "precision_policy/ivf_route_cap/query_tile/query_bucket/"
                "dispatch_depth/donate"
            )
        _refuse_inert_knobs(want)
        if want.nprobe is None:
            want = want.replace(nprobe=self.nprobe)
        return want


def _mesh_for(shards: int | None, mesh, cfg: KNNConfig, device):
    if mesh is not None and not isinstance(mesh, RingMesh) and any(
            isinstance(d, (list, tuple)) for d in mesh):
        raise ValueError(
            "the sharded clustered index wants a 1-D ring mesh, got a 2-D "
            "one (the candidate exchange is one group over the ring axis)")
    if shards is None:
        shards = (cfg.ivf_shards if cfg.ivf_shards is not None
                  else len(mesh) if mesh is not None else None)
    if shards is not None and shards < 1:
        raise ValueError(f"ivf_shards must be >= 1, got {shards}")
    from mpi_knn_tpu_torch.serve.index import canonical_device

    if mesh is None:
        mesh = make_ring_mesh(shards, axis_name=cfg.mesh_axis, device=device)
    # "cuda" and "cuda:0" name one card: every rank by its index
    mesh = RingMesh([canonical_device(d) for d in mesh],
                    getattr(mesh, "axis_name", cfg.mesh_axis))
    shards = len(mesh) if shards is None else shards
    if len(mesh) != shards:
        raise ValueError(
            f"mesh has {len(mesh)} device(s) but ivf_shards={shards}; build "
            "the mesh over exactly the shard count")
    return shards, mesh


def shard_ivf_index(index: IVFIndex, shards: int | None = None, mesh=None,
                    route_cap: int | None = None) -> ShardedIVFIndex:
    """Distribute a trained unsharded :class:`IVFIndex` over a 1-D ring
    mesh (default: ``shards`` ranks of the index's device type, the visible
    cards on CUDA, logical ranks on the CPU). The layout is derived here
    from (partitions, shards), so one saved index serves on any shard
    count. ``route_cap`` sets ``ivf_route_cap`` on the index's config."""
    shards, mesh = _mesh_for(shards, mesh, index.cfg, index.device)
    per_shard = -(-index.partitions // shards)
    padc = per_shard * shards - index.partitions
    dev = mesh[0]

    def padded(t, fill):
        if t is None:
            return None
        if padc:
            t = torch.cat([t, torch.full((padc,) + tuple(t.shape[1:]), fill,
                                         dtype=t.dtype, device=t.device)])
        return t

    store = (padded(index.buckets, 0), padded(index.bucket_ids, -1),
             padded(index.bucket_sqs, 0), padded(index.bucket_scales, 0))
    cfg = index.cfg.replace(
        ivf_shards=shards,
        ivf_route_cap=(route_cap if route_cap is not None
                       else index.cfg.ivf_route_cap))
    replicas = {}
    for d in mesh:
        d = torch.device(d)
        if d != dev and str(d) not in replicas:
            replicas[str(d)] = (index.centroids.to(d), index.centroid_sqs.to(d))
    common = dict(
        cfg=cfg, m=index.m, dim=index.dim, partitions=index.partitions,
        bucket_cap=index.bucket_cap, nprobe=index.nprobe, mu=index.mu,
        shards=shards, per_shard=per_shard, mesh=mesh, device=dev,
        centroids=index.centroids.to(dev), centroid_sqs=index.centroid_sqs.to(dev),
        tuned_recall=index.tuned_recall, build_seconds=dict(index.build_seconds),
        replicas=replicas)
    if _one_device(mesh):
        return ShardedIVFIndex(
            buckets=store[0].to(dev), bucket_ids=store[1].to(dev),
            bucket_sqs=store[2].to(dev),
            bucket_scales=None if store[3] is None else store[3].to(dev),
            **common)
    p = per_shard
    shard_store = [tuple(None if t is None else t[s * p:(s + 1) * p].to(d)
                         for t in store)
                   for s, d in enumerate(mesh)]
    return ShardedIVFIndex(buckets=None, bucket_ids=None, bucket_sqs=None,
                           shard_store=shard_store, **common)


def unshard_ivf_index(index: ShardedIVFIndex, device=None) -> IVFIndex:
    """The unsharded view of a sharded index on ``device`` (default: the
    index's), the derived padding clusters stripped: what
    ``save_ivf_index`` writes, so a sharded build saves the same ``.npz``
    as an unsharded one and reloads on any shard count."""
    dev = index.device if device is None else torch.device(device)
    Pn = index.partitions

    def whole(part):
        ts = [s[part] for s in index.slices]
        if ts[0] is None:
            return None
        return torch.cat([t.to(dev) for t in ts])[:Pn]

    return IVFIndex(
        cfg=index.cfg.replace(ivf_shards=None, ivf_route_cap=None),
        m=index.m, dim=index.dim, partitions=Pn, bucket_cap=index.bucket_cap,
        nprobe=index.nprobe, mu=index.mu, device=dev,
        centroids=index.centroids.to(dev), centroid_sqs=index.centroid_sqs.to(dev),
        buckets=whole(0), bucket_ids=whole(1), bucket_sqs=whole(2),
        bucket_scales=whole(3), tuned_recall=index.tuned_recall,
    )


def build_sharded_ivf_index(corpus, config: KNNConfig | None = None,
                            mesh=None, device=DEFAULT_DEVICE,
                            **overrides) -> ShardedIVFIndex:
    """Train the k-means partitioner on ``device`` (clustering does not
    depend on the layout) and distribute the index over the mesh.
    ``cfg.ivf_shards`` must be set; ``nprobe=None`` is tuned on the
    unsharded index first (recall does not depend on the layout at the
    safe route cap)."""
    from mpi_knn_tpu_torch.ivf.index import build_ivf_index

    cfg = (config or KNNConfig()).replace(**overrides)
    if cfg.ivf_shards is None:
        raise ValueError(
            "building a sharded clustered index requires ivf_shards "
            "(KNNConfig.ivf_shards); for an unsharded index use "
            "build_ivf_index")
    plain = build_ivf_index(corpus, cfg.replace(ivf_shards=None,
                                                ivf_route_cap=None),
                            device=device)
    return shard_ivf_index(plain, shards=cfg.ivf_shards, mesh=mesh,
                           route_cap=cfg.ivf_route_cap)


# ---------------------------------------------------------------------------
# One batch: tiles, the tile steps, the stats


def prepare_sharded_tiles(index: ShardedIVFIndex, queries, query_ids,
                          cfg: KNNConfig, assume_centered: bool = False):
    """Center with the index's mean (f64 on the host for numpy queries),
    pad to a multiple of S·q_tile and tile on the index's device. Returns
    (q_tiles, qid_tiles, q_pad, q_tile, route_cap)."""
    nq = queries.shape[0]
    q_ids = (np.full(nq, -1, dtype=np.int32) if query_ids is None
             else np.asarray(query_ids, dtype=np.int32))
    q = (queries.to(index.device) if isinstance(queries, torch.Tensor)
         else np.asarray(queries))
    if cfg.center and index.mu is not None and not assume_centered:
        q = center_rows(q, index.mu)
    q_tile, q_pad, route_cap = sharded_query_shapes(
        cfg, cfg.nprobe, index.bucket_cap, index.dim, nq, index.shards)
    qt = q_pad // q_tile
    q_tiles = pad_rows_any(q, q_pad, dtype=torch.float32,
                           device=index.device).reshape(qt, q_tile, index.dim)
    qid_tiles = pad_rows_any(q_ids, q_pad, fill=-1,
                             device=index.device).reshape(qt, q_tile)
    return q_tiles, qid_tiles, q_pad, q_tile, route_cap


def run_sharded_tiles(index: ShardedIVFIndex, q_tiles, qid_tiles,
                      cfg: KNNConfig, route_cap: int):
    """Every tile of one padded batch: shard h is the home of the tiles
    ``[h·QT/S, (h+1)·QT/S)``, and step j runs each shard's j-th tile
    together. Returns padded (QT, q_tile, k) dists and ids on the index's
    device and the (S, N_STATS) int64 stats summed over the steps (not
    synchronized)."""
    S = index.shards
    devices = [torch.device(d) for d in index.mesh]
    per = q_tiles.shape[0] // S
    homes = [(q_tiles[h * per:(h + 1) * per].to(devices[h]),
              qid_tiles[h * per:(h + 1) * per].to(devices[h]))
             for h in range(S)]
    cents = [index.centroid_replica(d) for d in devices]
    slices = index.slices
    d_out, i_out = [[] for _ in range(S)], [[] for _ in range(S)]
    stats = torch.zeros((S, N_STATS), dtype=torch.int64, device=index.device)
    for j in range(per):
        res, st = routed_query_tile([homes[h][0][j] for h in range(S)],
                                    [homes[h][1][j] for h in range(S)],
                                    cents, slices, cfg, cfg.nprobe, route_cap,
                                    devices)
        stats += st
        for h, (d, i) in enumerate(res):
            d_out[h].append(d)
            i_out[h].append(i)
    dev = index.device
    d = torch.stack([t.to(dev) for ts in d_out for t in ts])
    i = torch.stack([t.to(dev) for ts in i_out for t in ts])
    return d, i, stats


def search_ivf_sharded(index: ShardedIVFIndex, queries, query_ids=None,
                       config=None, assume_centered: bool = False,
                       device=DEFAULT_DEVICE, **overrides):
    """One query batch against a :class:`ShardedIVFIndex` (the one-shot
    search; the engine serves through the same tile steps). Returns ((q,
    k) dists ascending, (q, k) ids) on the index's device, which
    ``device`` must name, and the (S, N_STATS) int64 stats
    [routed, dropped, served] per shard."""
    from mpi_knn_tpu_torch.serve.index import canonical_device

    if canonical_device(device) != index.device:
        raise ValueError(
            f"device={str(device)!r} but the index lives on {index.device}")
    cfg = index.compatible_cfg((config or index.cfg).replace(**overrides))
    nq = queries.shape[0]
    q_tiles, qid_tiles, q_pad, _, route_cap = prepare_sharded_tiles(
        index, queries, query_ids, cfg, assume_centered=assume_centered)
    d, i, stats = run_sharded_tiles(index, q_tiles, qid_tiles, cfg, route_cap)
    return (d.reshape(q_pad, cfg.k)[:nq], i.reshape(q_pad, cfg.k)[:nq],
            stats)

"""Sharded clustered (IVF) index: the bucket store distributed over the
ring mesh with a routed candidate exchange (the JAX package's
``ivf/sharded.py``), run by one controlling process or by a pod of
processes, each holding its own shards.

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
bucket count. Over distinct cards, and across processes, each slice lives
on its own card (``shard_store``), and the mutation path writes each
slice in place on its card with the same freelist over the whole padded
store: a chunk's entries go to the shards that own their partitions, and
a compaction moves a live row to the card (or the process) of its new
partition. :attr:`ShardedIVFIndex.slices`, ``held`` and ``local_shards``
are the one place that knows where a shard lives.

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

Across processes (a mesh from ``parallel/mesh.make_ring_mesh`` after
``parallel/distributed.init_multihost``, n ranks a process): each process
holds its own n shards' slices (each on its rank's device) and their
centroid replicas, is the home of their runs of tiles, and the request
tables and candidate tiles move by ``torch.distributed.all_to_all_single``
(the reference's ``jax.lax.all_to_all``; ``distributed.all_to_all_rows``)
at the same shapes: one exchange a step carries every (home, owner) pair
between two processes, staged on the process's first device. So a pod of
S shards returns the unsharded index's results bit for bit, as S ranks of
one process do. Every process passes the whole batch and gets the whole
result back. Mutation of a store that spans processes, and serving it
through a session, follow the reference's multi-controller model: every
process makes the same calls with the same arguments in the same order,
each applies what falls into its own shards, and the processes agree on
each plan (``distributed.agree``) before any write.

Per-shard stats, summed over a batch's tiles: ``[routed, dropped,
served]`` (routes this shard's queries issued and kept, routes dropped at
the cap, real requests this shard answered as owner). A query whose every
probe was dropped retires all +inf with ids −1: a counted loss.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.ivf.index import IVFIndex, _refuse_inert_knobs
from mpi_knn_tpu_torch.ivf.search import finish_candidates, score_centroids
from mpi_knn_tpu_torch.ops.distance import center_rows
from mpi_knn_tpu_torch.ops.quant import QUANT_DTYPES, dequantize_rows, row_wire_bytes
from mpi_knn_tpu_torch.parallel import distributed
from mpi_knn_tpu_torch.parallel.mesh import RingMesh, make_ring_mesh
from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple
from mpi_knn_tpu_torch.shapes import (  # noqa: F401
    exchange_bytes_per_tile,
    exchange_elems,
    resolve_route_cap,
    sharded_q_tile,
    sharded_tile_elems,
)
from mpi_knn_tpu_torch.utils.op_trace import note_transfer

# per-shard exchange stats: routes this shard's queries issued and kept,
# routes dropped at the cap, real requests this shard answered as owner
STATS_FIELDS = ("routed", "dropped", "served")
N_STATS = len(STATS_FIELDS)


def exchange_wire_args(index) -> tuple[int, int, int]:
    """(lanes, itemsize, scale_bytes) of one candidate row on the exchange
    for ``index``'s store."""
    if getattr(index, "store_dtype", None) in QUANT_DTYPES:
        return index.held_slice[0].shape[-1], 1, 4
    return index.dim, index.held_slice[0].element_size(), 0


def sharded_query_shapes(cfg: KNNConfig, nprobe: int, bucket_cap: int,
                         dim: int, nq: int, shards: int) -> tuple[int, int, int]:
    """(q_tile, q_pad, route_cap) of a sharded batch: q_tile halves until
    both one tile's finish (q_tile·nprobe·cap·d) and its exchange buffer
    (S·route_cap·cap·d) fit ``cfg.max_tile_elems``; q_pad is a multiple of
    S·q_tile, so every shard holds as many whole tiles."""
    q_tile = sharded_q_tile(cfg, nprobe, bucket_cap, dim, nq, shards)
    biggest = sharded_tile_elems(cfg, nprobe, bucket_cap, dim, shards, q_tile)
    if biggest > cfg.max_tile_elems:
        raise ValueError(
            f"one sharded query tile's working set ({biggest} "
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


def _gather_slice(req_in, slice_, per_shard: int):
    """An owner's answer to its (S, route_cap) requests: the requested
    buckets gathered from its slice at rest (an empty slot gathers slot 0,
    its ids forced to −1), and the count of real requests."""
    buckets, bids, bsqs, bscl = slice_
    take = req_in.clamp(0, per_shard - 1).long()
    empty = (req_in < 0)[..., None]
    return ((buckets[take], torch.where(empty, -1, bids[take]), bsqs[take],
             None if bscl is None else bscl[take]),
            (req_in >= 0).sum())


def _finish_home(home, q_ids, tile, cfg: KNNConfig, nprobe: int,
                 route_cap: int, cap: int):
    """A home's finish: its candidates from ``tile(part)`` (the (S·
    route_cap, cap, ·) rows, ids, norms or scales every owner returned to
    it, in owner order) laid out in query-major probe order (the unsharded
    gather's layout: f = q·nprobe + j is route t = j·q_tile + q),
    dequantized there, finished. Returns ((q_tile, k) dists, ids) and the
    [routed, dropped] counts."""
    qx, q_sq, dest_t, rank_t, dropped_t = home
    dev = qx.device
    qt = qx.shape[0]
    n = qt * nprobe
    f = torch.arange(n, device=dev)
    t_of = (f % nprobe) * qt + f // nprobe
    dest, rank, dropped = dest_t[t_of], rank_t[t_of], dropped_t[t_of]
    src = dest * route_cap + rank.clamp(max=route_cap - 1)
    v = nprobe * cap
    rows = tile(0)[src]
    rows = rows.reshape(qt, v, rows.shape[-1])
    ids = torch.where(dropped[:, None], -1, tile(1)[src]).reshape(qt, v)
    sqs = tile(2)[src].reshape(qt, v)
    scales = tile(3)
    if scales is not None:
        # dequantized at home, after the exchange moved the codes
        rows = dequantize_rows(rows, scales[src].reshape(qt, v), cfg.dtype,
                               qx.shape[1])
    return (finish_candidates(qx, q_ids, q_sq, rows.to(torch.float32), ids,
                              sqs, cfg),
            ((~dropped).sum(), dropped.sum()))


def _score_home(q_x, centroids, nprobe: int, per_shard: int, shards: int,
                route_cap: int):
    """A home tile's centroid score and routes: (home state, its (S,
    route_cap) request table)."""
    qx = q_x.to(torch.float32)
    q_sq, probe = score_centroids(qx, *centroids, nprobe)
    dest_t, rank_t, dropped_t, req = _routes(probe, per_shard, shards, route_cap)
    return (qx, q_sq, dest_t, rank_t, dropped_t), req


# the exchange's returns, in an owner's answer's order
EXCHANGE_RETURNS = ("rows", "ids", "norms", "scales")


def note_exchange(part: str, tables) -> None:
    """Log one all-to-all of the candidate exchange (its ``part``, the
    bytes every shard sends) in an open trace (``utils/op_trace.py``)."""
    note_transfer("exchange", part=part,
                  bytes=sum(t.numel() * t.element_size() for t in tables))


def routed_query_tile_across(q_x, q_ids, centroids, slices, cfg: KNNConfig,
                             nprobe: int, route_cap: int, shards: int, devices):
    """One tile step in one process of a pod holding n shards: per local
    shard i its home tile ``q_x[i]`` (its ``q_ids[i]``), centroid replica
    ``centroids[i]`` and store slice ``slices[i]`` on ``devices[i]``. The
    request tables and the candidate tiles move between processes by
    ``all_to_all_single``, every (home, owner) pair of two processes in
    one exchange, on ``devices[0]``. Returns per local shard ((q_tile, k)
    dists, ids) and the (n, N_STATS) int64 stats on ``devices[0]``."""
    n = len(slices)
    procs, dev0 = shards // n, devices[0]
    per_shard, cap = slices[0][0].shape[:2]
    homes, reqs = [], []
    for i in range(n):
        home, req = _score_home(q_x[i], centroids[i], nprobe, per_shard, shards,
                                route_cap)
        homes.append(home)
        reqs.append(req.to(dev0))
    # (process, local home, local owner, route): part p to process p
    send = torch.stack(reqs).reshape(n, procs, n, route_cap).transpose(0, 1)
    got = distributed.all_to_all_rows(send.contiguous())
    answers, served = [], []
    for o in range(n):  # as owner: every home's requests, in home order
        req_in = got[:, :, o].reshape(shards, route_cap).to(devices[o])
        answer, count = _gather_slice(req_in, slices[o], per_shard)
        answers.append(answer)
        served.append(count.to(dev0))

    def back(part):  # (process, local owner, local home, route, ...)
        if answers[0][part] is None:
            return None
        t = torch.stack([a[part].to(dev0).reshape((procs, n, route_cap)
                                                  + a[part].shape[2:])
                         for a in answers], 1)
        return distributed.all_to_all_rows(t.contiguous())

    returned = [back(part) for part in range(4)]
    out, stats = [], []
    for i in range(n):
        def tile(part, i=i):
            t = returned[part]
            return None if t is None else t[:, :, i].reshape(
                (shards * route_cap,) + t.shape[4:]).to(devices[i])

        res, (routed, dropped) = _finish_home(homes[i], q_ids[i], tile, cfg,
                                              nprobe, route_cap, cap)
        out.append(res)
        stats.append(torch.stack([routed.to(dev0), dropped.to(dev0), served[i]]))
    return out, torch.stack(stats)


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
        home, r = _score_home(q_x[h], centroids[h], nprobe, per_shard, shards,
                              route_cap)
        homes.append(home)
        req.append(r)

    # owner side: the requests from every home, then the requested buckets
    note_exchange("requests", req)
    returned, served = [], []
    for o in range(shards):
        req_in = torch.stack([req[h][o].to(devices[o]) for h in range(shards)])
        answer, n = _gather_slice(req_in, slices[o], per_shard)
        returned.append(answer)
        served.append(n)

    for part, name in enumerate(EXCHANGE_RETURNS):
        if returned[0][part] is not None:
            note_exchange(name, [a[part] for a in returned])
    out, stats = [], []
    for h in range(shards):
        dev = devices[h]

        def home_tile(part):
            if returned[0][part] is None:
                return None
            return torch.cat([returned[o][part][h].to(dev) for o in range(shards)])

        res, (routed, dropped) = _finish_home(homes[h], q_ids[h], home_tile, cfg,
                                              nprobe, route_cap, cap)
        out.append(res)
        stats.append(torch.stack([routed, dropped, served[h].to(dev)]).to(devices[0]))
    return out, torch.stack(stats)


# ---------------------------------------------------------------------------
# The resident sharded index


def _one_device(mesh) -> bool:
    return len({str(d) for d in mesh}) == 1


def _spans_processes(mesh) -> bool:
    return getattr(mesh, "owners", None) is not None and mesh.spans_processes()


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
    ``slices`` holds each shard's tensors on its card; across processes
    (``spans_processes``) ``slices`` holds this process's shards alone,
    None at the others, and ``device`` is this process's first."""

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
    spans_processes: bool = False
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def local_shards(self) -> range:
        """The shards this process holds (every shard in one process)."""
        if not self.spans_processes:
            return range(self.shards)
        return self.mesh.local_ranks(distributed.process_index())

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

    @property
    def held_slice(self) -> tuple:
        """A shard's slice this process holds (its own across processes)."""
        return next(s for s in self.slices if s is not None)

    def centroid_replica(self, device) -> tuple:
        """(centroids, norms) on ``device``."""
        dev = torch.device(device)
        if dev == self.device:
            return self.centroids, self.centroid_sqs
        return self.replicas[str(dev)]

    def held(self) -> list:
        """(shard, slice) of every shard this process holds, in shard
        order."""
        slices = self.slices
        return [(s, slices[s]) for s in self.local_shards]

    def shard_owners(self) -> np.ndarray:
        """The process that holds each shard (all 0 in one process)."""
        if not self.spans_processes:
            return np.zeros(self.shards, np.int64)
        return np.asarray(self.mesh.owners, np.int64)

    def set_centroids(self, centroids, centroid_sqs) -> None:
        """New (retrained) centroids on ``device`` and on every card that
        holds a replica, so no search scores against stale ones."""
        self.centroids, self.centroid_sqs = centroids, centroid_sqs
        for key in self.replicas:
            self.replicas[key] = (centroids.to(key), centroid_sqs.to(key))

    @property
    def live_rows(self) -> int:
        from mpi_knn_tpu_torch.ivf.mutate import freelist_of

        return freelist_of(self).live

    @property
    def nbytes_resident(self) -> int:
        """Bytes of the store over every shard (padding clusters and a
        quantized store's scales included)."""
        return self.shard_nbytes_resident * self.shards

    @property
    def shard_nbytes_resident(self) -> int:
        """Bytes of one shard's slice."""
        return sum(t.numel() * t.element_size()
                   for t in (self.held_slice[0], self.held_slice[3]) if t is not None)

    @property
    def probe_bytes(self) -> int:
        """Bytes one query row's probes touch at the default nprobe, at the
        store's width (the unsharded bound: the same buckets move)."""
        quant = self.store_dtype if self.store_dtype in QUANT_DTYPES else None
        return self.nprobe * self.bucket_cap * row_wire_bytes(
            self.dim, quant, self.held_slice[0].element_size())

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


# ---------------------------------------------------------------------------
# A sliced store's rows between cards and processes (the mutation path)


def store_id_plane(index: ShardedIVFIndex) -> np.ndarray:
    """The whole padded store's id plane ``(S·per_shard, cap)`` on the
    host, in shard order: the slices' ids copied from their cards, and
    across processes gathered from every process (a collective)."""
    held = torch.cat([sl[1].to(index.device) for _, sl in index.held()]).cpu()
    if index.spans_processes:
        with distributed.collective("freelist derivation"):
            held = distributed.all_gather_rows(held)
    return held.numpy()


def pack_rows(parts) -> torch.Tensor:
    """Row-aligned tensors (None skipped) as one ``(n, bytes)`` uint8
    tensor: each row's bytes side by side, so one exchange moves them."""
    parts = [t for t in parts if t is not None]
    n = parts[0].shape[0]
    return torch.cat([t.contiguous().reshape(n, -1).view(torch.uint8)
                      for t in parts], 1)


def unpack_rows(buf: torch.Tensor, likes) -> list:
    """:func:`pack_rows` undone: ``likes`` are tensors (or None) with the
    parts' dtypes and trailing shapes."""
    out, at, n = [], 0, buf.shape[0]
    for like in likes:
        if like is None:
            out.append(None)
            continue
        tail = tuple(like.shape[1:])
        width = int(np.prod(tail, dtype=np.int64)) * like.element_size()
        out.append(buf[:, at:at + width].contiguous().view(like.dtype)
                   .reshape((n,) + tail))
        at += width
    return out


def move_rows(index: ShardedIVFIndex, sends: dict, counts: np.ndarray,
              width: int) -> dict:
    """One all-to-all of packed rows across the pod: ``sends[q]`` (uint8,
    ``(counts[me, q], width)``) goes to process q, and the rows process q
    sends here come back as ``{q: (counts[q, me], width)}`` on the
    index's device. ``counts`` (P, P) is known to every process (it comes
    from a plan they agreed on), so only the rows move, padded to its
    largest entry; none moves, and no collective runs, where it is 0."""
    procs, me = distributed.process_count(), distributed.process_index()
    most = int(counts.max()) if counts.size else 0
    if most == 0:
        return {}
    t0 = time.perf_counter()
    buf = torch.zeros((procs, most, width), dtype=torch.uint8, device=index.device)
    for q, rows in sends.items():
        buf[q, :rows.shape[0]] = rows.to(index.device)
    with distributed.collective("store row exchange"):
        got = distributed.all_to_all_rows(buf)
    distributed.COLLECTIVES["row_moves"] += 1
    distributed.COLLECTIVES["row_bytes_sent"] += int(
        (counts[me].sum() - counts[me, me]) * width)
    distributed.COLLECTIVES["row_seconds"] += time.perf_counter() - t0
    return {q: got[q, :int(counts[q, me])] for q in range(procs)
            if q != me and counts[q, me]}


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
                    getattr(mesh, "axis_name", cfg.mesh_axis),
                    owners=getattr(mesh, "owners", None))
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
    across = _spans_processes(mesh)
    mine = mesh.local_ranks(distributed.process_index()) if across else range(shards)
    dev = mesh[mine[0]]

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
    for d in [mesh[s] for s in mine]:
        d = torch.device(d)
        if d != dev and str(d) not in replicas:
            replicas[str(d)] = (index.centroids.to(d), index.centroid_sqs.to(d))
    common = dict(
        cfg=cfg, m=index.m, dim=index.dim, partitions=index.partitions,
        bucket_cap=index.bucket_cap, nprobe=index.nprobe, mu=index.mu,
        shards=shards, per_shard=per_shard, mesh=mesh, device=dev,
        centroids=index.centroids.to(dev), centroid_sqs=index.centroid_sqs.to(dev),
        tuned_recall=index.tuned_recall, build_seconds=dict(index.build_seconds),
        replicas=replicas, spans_processes=across)
    # the sharded index owns its store: mutation writes it in place, and
    # must never reach the unsharded index's tensors through a shared view
    if _one_device(mesh) and not across:
        return ShardedIVFIndex(
            buckets=store[0].to(dev, copy=True), bucket_ids=store[1].to(dev, copy=True),
            bucket_sqs=store[2].to(dev, copy=True),
            bucket_scales=None if store[3] is None else store[3].to(dev, copy=True),
            **common)
    p = per_shard
    shard_store = [tuple(None if t is None else t[s * p:(s + 1) * p].to(d, copy=True)
                         for t in store) if s in mine else None
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
        if index.spans_processes:
            held = [index.slices[s][part] for s in index.local_shards]
            return (None if held[0] is None else distributed.all_gather_rows(
                torch.cat([t.to(index.device) for t in held])).to(dev)[:Pn])
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
    if index.spans_processes:
        return _run_tiles_across(index, q_tiles, qid_tiles, cfg, route_cap)
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


def _run_tiles_across(index: ShardedIVFIndex, q_tiles, qid_tiles,
                      cfg: KNNConfig, route_cap: int):
    """:func:`run_sharded_tiles` in one process of a pod: this process is
    the home of its shards' runs of tiles and the owner of their slices;
    the results and stats of every process are gathered on each (process
    order is shard order)."""
    S, dev, mine = index.shards, index.device, index.local_shards
    per = q_tiles.shape[0] // S
    devices = [torch.device(index.mesh[s]) for s in mine]
    homes = [(q_tiles[h * per:(h + 1) * per].to(d), qid_tiles[h * per:(h + 1) * per].to(d))
             for h, d in zip(mine, devices)]
    cents = [index.centroid_replica(d) for d in devices]
    own = [index.slices[s] for s in mine]
    d_out, i_out = [[] for _ in mine], [[] for _ in mine]
    stats = torch.zeros((len(mine), N_STATS), dtype=torch.int64, device=dev)
    for j in range(per):
        res, st = routed_query_tile_across([q[j] for q, _ in homes],
                                           [i[j] for _, i in homes], cents, own,
                                           cfg, cfg.nprobe, route_cap, S, devices)
        stats += st
        for h, (d, i) in enumerate(res):
            d_out[h].append(d.to(dev))
            i_out[h].append(i.to(dev))
    d = distributed.all_gather_rows(torch.stack([t for ts in d_out for t in ts]))
    i = distributed.all_gather_rows(torch.stack([t for ts in i_out for t in ts]))
    return d, i, distributed.all_gather_rows(stats)


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

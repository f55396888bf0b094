"""Lloyd's k-means, the partitioner behind the clustered (IVF) index: the
JAX package's ``ivf/kmeans.py`` in PyTorch.

Init (k-means++ D²-sampling or a seeded random row draw), a fixed
``iters`` of Lloyd rounds, and a final assignment pass. Per round:

- **assignment**: ``ops.distance.pairwise_sq_l2`` (full f32) in row blocks
  of ``ASSIGN_BLOCK``, so only a (block × k) distance tile is live; the
  first minimum wins (``torch.argmin``, as ``jnp.argmin``);
- **update**: per-cluster sums and counts, then a masked divide. The sums
  are a one-hot product in f64 over row blocks, never a float
  ``index_add_``: on a card that scatters with atomics, whose sums change
  from run to run;
- **empty-cluster re-seed**: the j-th empty cluster is re-seeded to the
  j-th farthest point from its current centroid (a stable descending sort,
  so ties go to the lowest row as ``lax.top_k`` gives them).

The init draws from a ``torch.Generator`` seeded by ``seed`` (or the one
passed), so the port's centroids cannot equal the JAX package's bit for
bit; :func:`lloyd` takes initial centroids, which is how the tests feed it
the JAX package's own. Same (data, k, seed, init, iters, device) → the
same centroid bits.
"""

from __future__ import annotations

import dataclasses

import torch

from mpi_knn_tpu_torch.config import KMEANS_INITS
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.ops.distance import pairwise_sq_l2, sq_norms
from mpi_knn_tpu_torch.shapes import ASSIGN_BLOCK, SUM_BLOCK


@dataclasses.dataclass
class KMeansResult:
    """Trained partitioner state: (k, d) centroids, per-point assignments,
    per-cluster counts, and the mean squared assignment distance."""

    centroids: torch.Tensor  # (k, d) f32
    assignments: torch.Tensor  # (m,) int32
    counts: torch.Tensor  # (k,) int32
    inertia: torch.Tensor  # () f32


def assign_blocks(data, data_sq, centroids):
    """(m,) first-minimum cluster (int64) and (m,) min squared distance, in
    row blocks of ``ASSIGN_BLOCK``."""
    cent_sq = sq_norms(centroids)
    assign, min_d2 = [], []
    for s in range(0, data.shape[0], ASSIGN_BLOCK):
        dist = pairwise_sq_l2(data[s:s + ASSIGN_BLOCK], centroids,
                              x_sq=data_sq[s:s + ASSIGN_BLOCK], y_sq=cent_sq)
        assign.append(torch.argmin(dist, dim=-1))
        min_d2.append(torch.amin(dist, dim=-1))
    return torch.cat(assign), torch.cat(min_d2)


def segment_sums(data64, assign, k: int) -> torch.Tensor:
    """(k, d) f64 per-cluster row sums: one-hot products over row blocks,
    summed in block order, so the bits do not depend on a scatter's
    order."""
    labels = torch.arange(k, device=assign.device)[:, None]
    sums = data64.new_zeros((k, data64.shape[1]))
    for s in range(0, data64.shape[0], SUM_BLOCK):
        onehot = (assign[None, s:s + SUM_BLOCK] == labels).to(torch.float64)
        sums += onehot @ data64[s:s + SUM_BLOCK]
    return sums


def init_random(gen: torch.Generator, data, k: int):
    """k distinct data rows by a seeded permutation draw."""
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm[:k]]


def init_kmeanspp(gen: torch.Generator, data, data_sq, k: int):
    """k-means++ D² sampling: first centroid uniform, each next drawn with
    probability proportional to its squared distance to the nearest chosen
    centroid (floored at 1e-30, as the JAX package's logits are, so the
    draw stays defined when every point coincides with a centroid)."""
    m = data.shape[0]
    idx = torch.randint(0, m, (1,), generator=gen, device=data.device)
    cents = data.new_zeros((k, data.shape[1]))
    cents[0] = data[idx[0]]
    min_d2 = pairwise_sq_l2(data, data[idx], x_sq=data_sq)[:, 0]
    for i in range(1, k):
        idx = torch.multinomial(torch.clamp_min(min_d2, 1e-30), 1,
                                generator=gen)
        cents[i] = data[idx[0]]
        d2 = pairwise_sq_l2(data, data[idx], x_sq=data_sq)[:, 0]
        min_d2 = torch.minimum(min_d2, d2)
    return cents


def lloyd(data, centroids, iters: int) -> KMeansResult:
    """``iters`` Lloyd rounds from the given (k, d) centroids on (m, d)
    data (tensors on one device), then the final assignment."""
    data = data.to(torch.float32)
    centroids = centroids.to(torch.float32)
    k = centroids.shape[0]
    data_sq = sq_norms(data)
    data64 = data.to(torch.float64)
    for _ in range(iters):
        assign, min_d2 = assign_blocks(data, data_sq, centroids)
        counts = torch.bincount(assign, minlength=k)
        sums = segment_sums(data64, assign, k)
        new = (sums / torch.clamp_min(counts, 1)[:, None]).to(torch.float32)
        empty = counts == 0
        far = torch.sort(min_d2, descending=True, stable=True).indices[:k]
        erank = torch.clamp(torch.cumsum(empty, 0) - 1, 0, k - 1)
        centroids = torch.where(empty[:, None], data[far[erank]], new)
    assign, min_d2 = assign_blocks(data, data_sq, centroids)
    counts = torch.bincount(assign, minlength=k)
    return KMeansResult(centroids=centroids,
                        assignments=assign.to(torch.int32),
                        counts=counts.to(torch.int32),
                        inertia=min_d2.mean())


def kmeans(data, k: int, *, iters: int = 25, seed: int = 0,
           init: str = "kmeans++", generator: torch.Generator | None = None,
           device=DEFAULT_DEVICE) -> KMeansResult:
    """Train a k-partition Lloyd's k-means on (m, d) data (numpy or a
    tensor) on ``device``. The init draws from ``generator``, by default
    one on ``device`` seeded with ``seed``."""
    if init not in KMEANS_INITS:
        raise ValueError(f"unknown kmeans init {init!r}")
    m = int(data.shape[0])
    if not 1 <= k <= m:
        raise ValueError(f"k must be in [1, m={m}], got {k}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = resolve_device(device)
    data = torch.as_tensor(data).to(dev, torch.float32)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    if init == "kmeans++":
        cents = init_kmeanspp(generator, data, sq_norms(data), k)
    else:
        cents = init_random(generator, data, k)
    return lloyd(data, cents, iters)

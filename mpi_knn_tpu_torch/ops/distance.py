"""Pairwise distances in matmul form, ``‖x − y‖² = ‖x‖² + ‖y‖² − 2·x·yᵀ``,
compared in squared space (sqrt is monotone).

The product is ``torch.matmul`` at full f32 (or f64), never single-pass
TF32. bf16 inputs are widened to f32 before the product,
which equals the JAX package's bf16 dot with f32 accumulation (bf16 values
are exact in f32).
"""

from __future__ import annotations

import numpy as np
import torch

# Norm-squared clamp used by _l2_normalize: a row with sq_norm <= this is NOT
# normalized to unit length, so callers relying on unit rows (the fused
# backend's cosine d² = 2·d_cos) must treat it as degenerate.
_NORM_EPS = 1e-30


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f64 inputs accumulate in f64, anything else in f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def center_for_l2(corpus, queries, all_pairs: bool):
    """Mean-center corpus (and queries consistently) before L2 distances.

    Host (numpy) inputs take the f64 mean and stay f64 until the backend
    casts them, so they are bitwise the JAX package's centered inputs.
    Tensor inputs are centered where they lie, in f32 (f64 for f64).
    """
    mu = l2_mean(corpus)
    corpus = corpus - mu
    queries = corpus if all_pairs else center_rows(queries, mu)
    return corpus, queries


def l2_mean(corpus):
    """The centering mean of ``center_for_l2``: the f64 mean of a host
    corpus, or a tensor's mean in its accumulation dtype where it lies."""
    if isinstance(corpus, torch.Tensor):
        return corpus.mean(dim=0, dtype=_acc_dtype(corpus))
    return np.asarray(corpus, dtype=np.float64).mean(axis=0)


def center_rows(x, mu):
    """``x − mu`` with a mean from ``center_for_l2``. A tensor minus a host
    (f64 numpy) mean subtracts it as an f64 tensor on the tensor's device,
    the values a CPU tensor minus the array gives."""
    if isinstance(x, torch.Tensor) and not isinstance(mu, torch.Tensor):
        mu = torch.as_tensor(mu, device=x.device)
    return x - mu


def _check_full_precision(x: torch.Tensor):
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the exact "
            "policy's zero-exclusion rtol needs full-f32 products"
        )


def _mm_t(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x · yᵀ in the accumulation dtype."""
    _check_full_precision(x)
    acc = _acc_dtype(x)
    return torch.matmul(x.to(acc), y.to(acc).T)


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms, accumulated at full precision. (r, d) -> (r,)."""
    xa = x.to(_acc_dtype(x))
    return torch.sum(xa * xa, dim=-1)


def pairwise_sq_l2(x, y, x_sq=None, y_sq=None) -> torch.Tensor:
    """Squared L2 distances between rows of x (q, d) and y (c, d) -> (q, c)."""
    if x_sq is None:
        x_sq = sq_norms(x)
    if y_sq is None:
        y_sq = sq_norms(y)
    d = x_sq[:, None] - 2.0 * _mm_t(x, y) + y_sq[None, :]
    # cancellation can leave tiny negatives; clamp keeps NaN as NaN
    return torch.clamp_min(d, 0.0)


def _l2_normalize(x: torch.Tensor, eps: float = _NORM_EPS) -> torch.Tensor:
    acc = _acc_dtype(x)
    n = torch.sqrt(torch.clamp_min(sq_norms(x), eps)).to(acc)
    return x.to(acc) / n[:, None]


def pairwise_cosine(x, y) -> torch.Tensor:
    """Cosine distance (1 − cosine similarity), range [0, 2]."""
    sim = _mm_t(_l2_normalize(x), _l2_normalize(y))
    return torch.clamp_min(1.0 - sim, 0.0)


def pairwise_dist(x, y, metric: str = "l2", x_sq=None, y_sq=None):
    """Dispatch on metric; returns distances in sortable space."""
    if metric == "l2":
        return pairwise_sq_l2(x, y, x_sq=x_sq, y_sq=y_sq)
    if metric == "cosine":
        return pairwise_cosine(x, y)
    raise ValueError(f"unknown metric {metric!r}")

"""The port's kernels and their plain versions. Each kernel module keeps a
``LAUNCHES`` counter per kernel, which its wrapper raises by one where it
launches on a card."""


def launch_counts() -> dict:
    """Every hand kernel's launch counter, by name (the wrappers count a
    launch only on a card)."""
    from mpi_knn_tpu_torch.ops import approx_topk, fused_knn, fused_ring, fused_rotation

    return {**fused_knn.LAUNCHES, **fused_ring.LAUNCHES,
            **fused_rotation.LAUNCHES, **approx_topk.LAUNCHES}

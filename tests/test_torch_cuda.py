"""The CUDA kernels against their plain versions on the card. These need a
CUDA device and nvcc; they skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from mpi_knn_tpu_torch.ops import fused_knn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("k", [10, 150])  # 150: lists kept in the output
def test_kernel_equals_plain_on_small_integers(cuda_device, name, all_pairs, k):
    rng = np.random.default_rng(0)
    X = torch.from_numpy((rng.integers(0, 8, (512, 32)) * 0.25).astype(np.float32))
    X[5] = X[60]
    Q = X if all_pairs else X[:128] + 0.25
    Q, X = Q.to(cuda_device), X.to(cuda_device)
    kern = getattr(fused_knn, name)
    plain = getattr(fused_knn, name + "_reference")
    before = fused_knn.LAUNCHES[name]
    gd, gi = kern(Q, X, 500, k, 128, 256, all_pairs=all_pairs)
    torch.cuda.synchronize()
    wd, wi = plain(Q, X, 500, k, 128, 256, all_pairs=all_pairs)
    assert fused_knn.LAUNCHES[name] == before + 1
    assert torch.equal(gi, wi)
    assert torch.equal(torch.nan_to_num(gd, posinf=-1.0),
                       torch.nan_to_num(wd, posinf=-1.0))

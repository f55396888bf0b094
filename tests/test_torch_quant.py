"""The port's int8 row quantization (``ops/quant.py``) against the JAX
package's, bit for bit: the same f32 division, multiply and half-to-even
rounding on both sides give the same codes and scales, and the dequantized
rows are one multiply each."""

import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops import quant as jq
from mpi_knn_tpu_torch.ops import quant as pq


def _both_quantize(x):
    jc, js = jq.quantize_rows(x, "int8")
    pc, ps = pq.quantize_rows(torch.from_numpy(x), "int8")
    return (np.array(jc), np.array(js)), (pc.numpy(), ps.numpy())


def _rows(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 48)) * 3.0).astype(np.float32)
    x[3] = 0.0                                  # a zero row
    x[5] = -np.abs(x[5])                        # all negative
    x[9, :] = 0.0
    x[9, 7] = 7.5                               # scale set by one element
    # values exactly at half a code step: with amax 127, code = x
    x[11] = np.arange(48, dtype=np.float32) - 23.5
    x[11, 0] = 127.0
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bitwise_equal_to_jax(seed):
    x = _rows(seed)
    (jc, js), (pc, ps) = _both_quantize(x)
    assert pc.dtype == np.int8 and ps.dtype == np.float32
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(ps, js)
    assert (pc[3] == 0).all() and ps[3] == 0.0
    # half-to-even at the .5 steps: -23.5 -> -24, -22.5 -> -22, 0.5 -> 0
    assert pc[11, 0] == 127 and pc[11, 1] == -22 and pc[11, 24] == 0


def test_dequantize_rows_bitwise_equal_to_jax():
    x = _rows(2)
    (jc, js), _ = _both_quantize(x)
    want = np.asarray(jq.dequantize_rows(jc, js, "int8", x.shape[1]))
    got = pq.dequantize_rows(torch.from_numpy(jc), torch.from_numpy(js))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[3] == 0).all()
    scale = js[:, None]
    assert (np.abs(got.numpy() - x) <= scale / 2 + 1e-6 * scale).all()


def test_quant_helpers_match_jax():
    assert pq.quant_max("int8") == jq.quant_max("int8")
    for dtype, itemsize in ((None, 4), (None, 2), ("int8", 4)):
        assert (pq.row_wire_bytes(784, dtype, itemsize)
                == jq.row_wire_bytes(784, dtype, itemsize))
    with pytest.raises(ValueError, match="int8"):
        pq.quant_max("int4")

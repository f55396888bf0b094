"""The port's row quantization (``ops/quant.py``) against the JAX
package's, bit for bit: the same f32 division, multiply and half-to-even
rounding on both sides give the same codes and scales, and the dequantized
rows are one multiply each. int4 (the clustered index's store) packs two
codes a lane, low nibble first, with a zero nibble for odd widths."""

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
    assert pq.quant_max("int4") == jq.quant_max("int4")
    for dtype, itemsize in ((None, 4), (None, 2), ("int8", 4), ("int4", 4)):
        for dim in (784, 128, 33):
            assert (pq.row_wire_bytes(dim, dtype, itemsize)
                    == jq.row_wire_bytes(dim, dtype, itemsize))
    for dim in (1, 32, 33):
        for dtype in pq.QUANT_DTYPES:
            assert pq.packed_dim(dim, dtype) == jq.packed_dim(dim, dtype)
    assert pq.row_wire_bytes(128, "int4") == 68
    with pytest.raises(ValueError, match="int8"):
        pq.quant_max("int2")


@pytest.mark.parametrize("dim", [1, 31, 32, 48])
def test_int4_pack_and_unpack_bitwise_equal_to_jax(dim):
    rng = np.random.default_rng(dim)
    codes = rng.integers(-7, 8, (64, dim)).astype(np.int8)
    codes[0] = -7
    codes[1] = 7
    want = np.asarray(jq.pack_int4(codes))
    got = pq.pack_int4(torch.from_numpy(codes))
    assert got.dtype == torch.int8 and got.shape == (64, -(-dim // 2))
    np.testing.assert_array_equal(got.numpy(), want)
    back = pq.unpack_int4(got, dim)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jq.unpack_int4(want, dim)))


@pytest.mark.parametrize("dim", [31, 48])
@pytest.mark.parametrize("seed", [0, 1])
def test_int4_quantize_and_dequantize_bitwise_equal_to_jax(seed, dim):
    x = _rows(seed)[:, :dim]
    jc, js = jq.quantize_rows(x, "int4")
    pc, ps = pq.quantize_rows(torch.from_numpy(x), "int4")
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    want = np.asarray(jq.dequantize_rows(jc, js, "int4", dim))
    got = pq.dequantize_rows(pc, ps, "int4", dim)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[3] == 0).all()
    # every element within half a step (scale = max|row| / 7)
    scale = np.asarray(js)[:, None]
    assert (np.abs(got.numpy() - x) <= scale / 2 + 1e-6 * scale).all()

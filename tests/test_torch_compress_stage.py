"""The compress kernels' staging prologue (``fused_knn.stage_bf16_rows`` and
``fused_ring.stage_wire_rows``; on the CPU their plain version
``stage_bf16_rows_reference``) against the JAX package on the same rows.

The prologue hands the bf16 tensor-core tile two things per row: a bf16
copy rounded to nearest even, which must equal ``x.astype(jnp.bfloat16)``
bit for bit, and the f32 squared norm of the unrounded (on the int8 wire:
dequantized) row, which must equal ``jnp.sum(x * x, -1)`` within rtol 1e-6
(the sum orders differ). Zero padding of the width changes neither.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops.quant import dequantize_rows as jax_dequantize
from mpi_knn_tpu.ops.quant import quantize_rows as jax_quantize
from mpi_knn_tpu_torch.ops import fused_knn, fused_ring

DIM = 50  # not a multiple of the staged depth: the copy is padded to 64


def _rows(seed, n=40):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, DIM)) * 3.0).astype(np.float32)
    x[3, 7] = 1.00390625   # a bf16 halfway case: rounds to even (1.0)
    x[4, 0] = np.finfo(np.float32).max  # rounds past the bf16 range: inf
    x[5] = 0.0             # a zero row
    return x


def _jax_rows(x, wire):
    """(the rows the wire decodes to, f32 numpy; port block, port scale)."""
    if wire == "int8":
        codes, scale = jax_quantize(x, "int8")
        rows = np.asarray(jax_dequantize(codes, scale, "int8", DIM))
        return rows, torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scale))
    if wire == "bfloat16":
        rows = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        return rows, torch.from_numpy(x).to(torch.bfloat16), None
    return x, torch.from_numpy(x), None


def _stage(entry, block, scale):
    if entry == "knn":
        return fused_knn.stage_bf16_rows(block)
    return fused_ring.stage_wire_rows(block, scale)


CASES = [("knn", "float32"), ("ring", "float32"), ("ring", "bfloat16"),
         ("ring", "int8")]


@pytest.mark.parametrize("entry,wire", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_staged_copy_and_norms_equal_jax(entry, wire, seed):
    x = _rows(seed)
    if wire == "int8":
        x[4, 0] = 40.0  # keep the scale finite
    rows, block, scale = _jax_rows(x, wire)
    copy, norms = _stage(entry, block, scale)
    assert copy.dtype == torch.bfloat16 and norms.dtype == torch.float32
    assert copy.shape == (len(x), fused_knn.staged_width(DIM)) == (len(x), 64)
    want_copy = np.asarray(jnp.asarray(rows).astype(jnp.bfloat16)).view(np.uint16)
    got_copy = copy.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_copy[:, :DIM], want_copy)
    assert (got_copy[:, DIM:] == 0).all()
    want_norms = np.asarray(jnp.sum(jnp.asarray(rows) * jnp.asarray(rows), -1))
    np.testing.assert_allclose(norms.numpy(), want_norms, rtol=1e-6)
    assert norms[5] == 0.0
    if wire != "int8":
        assert got_copy[3, 7] == 0x3F80 and got_copy[4, 0] == 0x7F80


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("width", [50, 64, 128])
def test_zero_padding_leaves_copy_and_norms_unchanged(wire, width):
    x = _rows(2)
    x[4, 0] = 40.0
    rows, _, _ = _jax_rows(x, wire)
    rows = torch.from_numpy(np.array(rows))
    base_copy, base_norms = fused_knn.stage_bf16_rows_reference(rows)
    copy, norms = fused_knn.stage_bf16_rows_reference(rows, width)
    assert copy.shape == (len(x), width)
    assert torch.equal(copy[:, :DIM], base_copy)
    assert not copy[:, DIM:].float().any()
    assert torch.equal(norms, base_norms)


def test_plain_staging_counts_no_launch():
    fused_knn.reset_launch_counts()
    fused_ring.reset_launch_counts()
    x = torch.from_numpy(_rows(3))
    fused_knn.stage_bf16_rows(x)
    fused_ring.stage_wire_rows(x, None)
    assert fused_knn.LAUNCHES["stage_bf16"] == 0
    assert fused_ring.LAUNCHES["stage_bf16[wire]"] == 0


def test_stage_refuses_non_f32_rows():
    with pytest.raises(TypeError, match="float32"):
        fused_knn.stage_bf16_rows(torch.zeros(4, 8, dtype=torch.float64))

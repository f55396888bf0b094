"""Block-scaled int8 quantization of corpus rows, the ring's int8 wire
(``KNNConfig.ring_transfer_dtype="int8"``): the JAX package's
``ops/quant.py``, int8 part.

Symmetric per-row scaling: ``scale = max|row| / 127`` and ``code =
round(row / scale)`` in [−127, 127], so every element's reconstruction
error is at most scale/2. A zero row gets scale 0 and all-zero codes; no
division by zero happens anywhere. Rounding is half-to-even, as
``jnp.round`` does, so codes equal the JAX package's bit for bit.

The int4 packing of the clustered index waits for that slice.
"""

from __future__ import annotations

import torch

_QMAX = {"int8": 127}


def quant_max(dtype: str) -> int:
    """Largest code magnitude of a quantized dtype (symmetric range)."""
    try:
        return _QMAX[dtype]
    except KeyError:
        raise ValueError(
            f"quantized dtype must be one of {tuple(_QMAX)}, got {dtype!r}"
        ) from None


def row_wire_bytes(dim: int, dtype, itemsize: int = 4) -> int:
    """Bytes one corpus row occupies on the wire: int8 codes plus one f32
    scale for the quantized level, else ``dim`` floats of ``itemsize``."""
    if dtype in _QMAX:
        return dim + 4
    return dim * itemsize


def quantize_rows(x: torch.Tensor, dtype: str = "int8"):
    """(…, d) float → ((…, d) int8 codes, (…,) f32 scales)."""
    qmax = quant_max(dtype)
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    scale = amax / qmax
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    inv = torch.where(amax > 0, qmax / safe, torch.zeros_like(amax))
    codes = torch.clamp(torch.round(x * inv[..., None]), -qmax, qmax)
    return codes.to(torch.int8), scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                    dtype: str = "int8") -> torch.Tensor:
    """(…, d) int8 codes + (…,) scales → (…, d) f32 rows: one convert and
    one multiply, as ``quant.py:140`` of the JAX package."""
    quant_max(dtype)
    return codes.to(torch.float32) * scales[..., None]

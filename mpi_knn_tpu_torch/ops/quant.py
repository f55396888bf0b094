"""Block-scaled integer quantization of corpus rows: the JAX package's
``ops/quant.py``. Two widths, used in two places: the ring's int8 wire
(``KNNConfig.ring_transfer_dtype="int8"``) and the clustered index's
int8 / int4 bucket stores at rest (``ivf/``), dequantized right after the
probe gather.

Symmetric per-row scaling: ``scale = max|row| / QMAX`` and ``code =
round(row / scale)`` in [−QMAX, QMAX], so every element's reconstruction
error is at most scale/2. A zero row gets scale 0 and all-zero codes; no
division by zero happens anywhere. Rounding is half-to-even, as
``jnp.round`` does, so codes equal the JAX package's bit for bit.

``int4`` packs two codes per int8 lane (low nibble first, two's
complement, QMAX = 7 so −8 never appears); the packed axis is
``ceil(d/2)`` lanes with a zero nibble pad for odd d. Unpacking is exact:
torch's int8 shifts are arithmetic, so ``(p << 4) >> 4`` sign-extends the
low nibble as JAX's do.
"""

from __future__ import annotations

import torch

QUANT_DTYPES = ("int8", "int4")
_QMAX = {"int8": 127, "int4": 7}


def quant_max(dtype: str) -> int:
    """Largest code magnitude of a quantized dtype (symmetric range)."""
    try:
        return _QMAX[dtype]
    except KeyError:
        raise ValueError(
            f"quantized dtype must be one of {QUANT_DTYPES}, got {dtype!r}"
        ) from None


def packed_dim(dim: int, dtype: str) -> int:
    """int8 lanes per row of a ``dim``-wide quantized row: int8 stores one
    code per lane, int4 two (odd dims carry one zero nibble)."""
    quant_max(dtype)
    return dim if dtype == "int8" else -(-dim // 2)


def row_wire_bytes(dim: int, dtype, itemsize: int = 4) -> int:
    """Bytes one corpus row occupies on the wire or at rest: its code lanes
    plus one f32 scale for a quantized level, else ``dim`` floats of
    ``itemsize``."""
    if dtype in QUANT_DTYPES:
        return packed_dim(dim, dtype) + 4
    return dim * itemsize


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [−7, 7] two per byte along the last axis (low
    nibble = even index). Odd-width rows pad with a zero nibble."""
    if codes.shape[-1] % 2:
        codes = torch.cat([codes, codes.new_zeros(codes.shape[:-1] + (1,))],
                          dim=-1)
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact inverse of :func:`pack_int4`: (…, ceil(dim/2)) int8 lanes →
    (…, dim) int8 codes."""
    packed = packed.to(torch.int8)
    lo = (packed << 4) >> 4
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))
    return out[..., :dim]


def quantize_rows(x: torch.Tensor, dtype: str = "int8"):
    """(…, d) float → ((…, pd) int8 codes, (…,) f32 scales), ``pd =
    packed_dim(d, dtype)``."""
    qmax = quant_max(dtype)
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    # QMAX as a tensor beside amax: a card divides by a host scalar as a
    # multiply by its reciprocal (one ulp off), and ``int / tensor`` is the
    # tensor's reciprocal times the int on every device; tensor by tensor
    # is the one rounding JAX's division makes
    qmax_t = torch.full_like(amax, qmax)
    scale = amax / qmax_t
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    inv = torch.where(amax > 0, qmax_t / safe, torch.zeros_like(amax))
    codes = torch.clamp(torch.round(x * inv[..., None]), -qmax, qmax)
    codes = codes.to(torch.int8)
    if dtype == "int4":
        codes = pack_int4(codes)
    return codes, scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                    dtype: str = "int8", dim: int | None = None
                    ) -> torch.Tensor:
    """(…, pd) int8 codes + (…,) scales → (…, dim) f32 rows: one convert and
    one multiply, as ``quant.py:140`` of the JAX package. ``dim`` defaults
    to every lane's codes (two a lane for int4)."""
    quant_max(dtype)
    if dtype == "int4":
        codes = unpack_int4(codes, 2 * codes.shape[-1] if dim is None else dim)
    return codes.to(torch.float32) * scales[..., None]

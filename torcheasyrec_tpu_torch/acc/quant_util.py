"""Embedding-table quantization for the serving export.

Counterpart of torcheasyrec_tpu/acc/quant_util.py, in numpy, bit for bit:
rowwise-symmetric INT8 with a per-row fp32 scale; INT4 and INT2 pack
two and four values a byte; FP16 is a cast. ``main.export`` writes a
group's ``values`` and ``scales`` when ``QUANT_EMB`` names a dtype, and
``main.predict`` dequantizes them.
"""

from typing import Dict, Tuple

import numpy as np

QUANT_DTYPES = ("INT8", "INT4", "INT2", "FP16")


def quantize_rowwise(
    table: np.ndarray, dtype: str = "INT8"
) -> Dict[str, np.ndarray]:
    """[rows, dim] fp32 -> dict(values, scales) in the requested dtype."""
    dtype = dtype.upper()
    table = np.asarray(table, np.float32)
    if dtype == "FP16":
        return {"values": table.astype(np.float16),
                "scales": np.ones((table.shape[0],), np.float32)}
    bits = {"INT8": 8, "INT4": 4, "INT2": 2}[dtype]
    qmax = float(2 ** (bits - 1) - 1)
    amax = np.abs(table).max(axis=1)
    scales = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(table / scales[:, None]), -qmax - 1, qmax
    ).astype(np.int8)
    if bits == 8:
        values = q
    elif bits == 4:
        dim = table.shape[1]
        pad = (-dim) % 2
        if pad:
            q = np.pad(q, ((0, 0), (0, pad)))
        u = (q + 8).astype(np.uint8)
        values = (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)
    else:  # INT2
        dim = table.shape[1]
        pad = (-dim) % 4
        if pad:
            q = np.pad(q, ((0, 0), (0, pad)))
        u = (q + 2).astype(np.uint8)
        values = (
            u[:, 0::4] | (u[:, 1::4] << 2) | (u[:, 2::4] << 4)
            | (u[:, 3::4] << 6)
        ).astype(np.uint8)
    return {"values": values, "scales": scales}


def dequantize_rowwise(
    quant: Dict[str, np.ndarray], dtype: str, dim: int
) -> np.ndarray:
    dtype = dtype.upper()
    values, scales = quant["values"], quant["scales"]
    if dtype == "FP16":
        return np.asarray(values, np.float32)
    if dtype == "INT8":
        q = np.asarray(values, np.float32)
    elif dtype == "INT4":
        u = np.asarray(values, np.uint8)
        lo = (u & 0x0F).astype(np.int16) - 8
        hi = (u >> 4).astype(np.int16) - 8
        q = np.empty((u.shape[0], u.shape[1] * 2), np.float32)
        q[:, 0::2] = lo
        q[:, 1::2] = hi
        q = q[:, :dim]
    else:  # INT2
        u = np.asarray(values, np.uint8)
        parts = [((u >> (2 * i)) & 0x3).astype(np.int16) - 2
                 for i in range(4)]
        q = np.empty((u.shape[0], u.shape[1] * 4), np.float32)
        for i, p in enumerate(parts):
            q[:, i::4] = p
        q = q[:, :dim]
    return q * quant["scales"][:, None]

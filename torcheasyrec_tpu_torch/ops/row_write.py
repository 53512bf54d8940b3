"""Row write: ``table[ids[k]] = rows[k]`` for every k, in place.

Counterpart of torcheasyrec_tpu/ops/pallas/row_write.py (``write_rows``
and the TPU kernel ``_write_kernel`` behind it). The embedding engine's
packed update writes whole 128-lane physical rows with it, once per
packed group and train step.

``write_rows`` launches the hand-written CUDA kernel
(``csrc/row_write.cu``: one warp per row, one 16-byte store per lane) on
CUDA tensors, or raises; it never gives way to the plain version there.
On CPU tensors it runs ``_torch_write_rows``, the plain version, which
the tests use and which ``chip_smoke.py`` holds the kernel against.
``write_rows.launches`` counts kernel launches.

Semantics, both versions: ids outside ``[0, P)`` are dropped, not
clamped (the JAX ``.at[ids].set(mode="drop")`` wraps negative ids
numpy-style first; the engine never sends one). Duplicate targets race,
so which row wins is undefined: the engine points every duplicate at one
scratch row that is never read, the table's last, and passes the table
without it (``table[:-1]``, a view), so that those writes are dropped as
ids past P. ids may be int32 (as in the JAX package)
or int64 (as torch indexing gives them); the kernel reads either as it
is, no conversion pass.
"""

import ctypes

import torch

from torcheasyrec_tpu_torch.ops import cuda_build


def supports_row_write(table_lanes: int) -> bool:
    return table_lanes % 128 == 0


def _torch_write_rows(table: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_copy_`` over the in-bounds ids."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < table.shape[0])
    table.index_copy_(0, ids[ok], rows[ok])
    return table


def check_write_inputs(table, ids, rows) -> None:
    """Raise unless the kernel takes these tensors as they are."""
    if table.dim() != 2 or rows.dim() != 2 or ids.dim() != 1:
        raise ValueError(
            f"expected table [P, L], ids [K] and rows [K, L], got "
            f"{tuple(table.shape)}, {tuple(ids.shape)}, {tuple(rows.shape)}")
    if rows.shape[1] != table.shape[1]:
        raise ValueError(
            f"row width {rows.shape[1]} != table lanes {table.shape[1]}")
    if rows.shape[0] != ids.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids for {rows.shape[0]} rows")
    if not supports_row_write(table.shape[1]):
        raise ValueError(
            f"table lanes must be a multiple of 128, got {table.shape[1]}")
    if table.dtype != torch.float32 or rows.dtype != torch.float32:
        raise ValueError(
            f"table and rows must be fp32, got {table.dtype}, {rows.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
    if ids.device != table.device or rows.device != table.device:
        raise ValueError("table, ids and rows must be on one device")
    for name, t in (("table", table), ("rows", rows)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")


def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("row_write")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.row_write.argtypes = [p, p, p, ll, ll, i, i, p]
        lib.row_write.restype = i
        lib.row_write_error_string.argtypes = [i]
        lib.row_write_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def write_rows(table: torch.Tensor, ids: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """``table[ids[k]] = rows[k]`` in place; returns ``table``.

    table [P, L] fp32 with L a multiple of 128, ids [K] int32 or int64,
    rows [K, L] fp32, all contiguous and on one device. On a CUDA table
    the kernel is launched on the current stream (so after the gathers
    of the same step that read the rows it overwrites) and its launch is
    counted; K = 0 returns without a launch."""
    check_write_inputs(table, ids, rows)
    k = ids.shape[0]
    if k == 0:
        return table
    if not table.is_cuda:
        return _torch_write_rows(table, ids, rows)
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        rc = lib.row_write(
            table.data_ptr(), ids.data_ptr(), rows.data_ptr(), k,
            table.shape[0], table.shape[1], int(ids.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        msg = lib.row_write_error_string(rc).decode()
        raise RuntimeError(f"row_write launch failed: {msg} ({rc})")
    write_rows.launches += 1
    return table


write_rows.launches = 0

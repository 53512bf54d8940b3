"""Batch of torch tensors, the per-batch host metadata beside it, and the
padding helpers that shape it.

Counterpart of torcheasyrec_tpu/datasets/utils.py. Shapes stay those of
the JAX package: a sparse feature is either fixed-length
(``values [B, L]``, ``lengths`` None) or jagged (``values [N_pad]`` with
``N_pad`` rounded up to a power of two, ``lengths [B]``); sequence
features are padded to their configured length. Padding ids are -1 and
gather zero rows. A ``Batch`` moves to a device with ``.to(device)``
and into page-locked host memory with ``.pin_memory()``.
"""

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

# checkpoint-position side columns the readers inject (source id: the
# file's index in the expanded path list; row index within that file)
CKPT_SOURCE_ID = "__ckpt_source_id__"
CKPT_ROW_IDX = "__ckpt_row_idx__"
DATA_TIMESTAMP = "__data_timestamp__"
# the hard-negative sampler's int32 [B * num_hard_sample, 2] (user row,
# hard column) pairs, popped from its output into
# ``Batch.additional["hard_neg_indices"]``; an empty slot's user row is B
HARD_NEG_INDICES = "__hard_neg_indices__"
# the data groups of the negative sampler: a NEG_DATA_GROUP feature's
# input gets the sampled items appended (B + num_sample rows), the
# BASE_DATA_GROUP ones keep the batch's B rows
BASE_DATA_GROUP = "__BASE__"
NEG_DATA_GROUP = "__NEG__"


def pa_from_numpy(arr: np.ndarray):
    """numpy -> pyarrow Array for null-free integer or bool columns, on
    the zero-copy path (``pa.array(ndarray)`` takes the generic converter;
    ``from_pandas`` maps float NaN to null, hence integers only)."""
    import pyarrow as pa

    return pa.Array.from_pandas(arr)


def bucketize_size(n: int, minimum: int = 16) -> int:
    """Round n up to the next power of two (>= minimum)."""
    m = max(int(n), minimum)
    return 1 << (m - 1).bit_length()


def _map(obj, fn: Callable[[Any], Any]):
    """``obj`` (a field dataclass, a dict of them or of tensors, a tensor,
    a plain value or None) with ``fn`` applied to every tensor (or numpy
    array, where ``to_numpy`` put one)."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if not dataclasses.is_dataclass(obj):
        return obj  # None, or Batch.tile_size
    return type(obj)(*(_map(getattr(obj, f.name), fn)
                       for f in dataclasses.fields(obj)))


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


@dataclasses.dataclass
class SparseField:
    """One sparse (id) feature: int32 ids, [B, L] fixed or [N_pad] jagged
    with int32 ``lengths [B]``; optional float32 weights shaped like
    ``values``."""

    values: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None

    @property
    def is_fixed(self) -> bool:
        return self.lengths is None


@dataclasses.dataclass
class DenseField:
    """One dense feature: float32 values [B, D]."""

    values: torch.Tensor


@dataclasses.dataclass
class SequenceDenseField:
    """A per-position dense sequence feature: values [B, L, D], lengths [B]."""

    values: torch.Tensor
    lengths: torch.Tensor


@dataclasses.dataclass
class Batch:
    """One step's input, keyed by feature name."""

    dense_features: Dict[str, DenseField] = dataclasses.field(default_factory=dict)
    sparse_features: Dict[str, SparseField] = dataclasses.field(default_factory=dict)
    sequence_sparse_features: Dict[str, SparseField] = dataclasses.field(
        default_factory=dict
    )
    sequence_dense_features: Dict[str, SequenceDenseField] = dataclasses.field(
        default_factory=dict
    )
    labels: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    sample_weights: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict
    )
    # other per-batch tensors, e.g. the hard negatives' "hard_neg_indices"
    additional: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict
    )
    # INPUT_TILE serving: the rows the user-side features (parsed from a
    # request's first row, [1, ...]) are tiled to; None otherwise
    tile_size: Optional[int] = None

    @property
    def host(self) -> Optional["Batch"]:
        """The host batch this one was copied from (None where it was not
        copied); where the copy was of a packed wire, rebuilt from the
        wire at the first read."""
        h = self.__dict__.get("_host")
        if callable(h):
            h = self.__dict__["_host"] = h()
        return h

    @host.setter
    def host(self, value: Optional["Batch"]) -> None:
        self.__dict__["_host"] = value

    def set_host(self, thunk: Callable[[], "Batch"]) -> None:
        """``host`` built by ``thunk`` at its first read."""
        self.__dict__["_host"] = thunk

    def keep_host(self, other: "Batch") -> None:
        """``other``'s host batch as this one's, still unbuilt if it is."""
        self.__dict__["_host"] = other.__dict__.get("_host")

    def to(self, device, non_blocking: bool = False) -> "Batch":
        """The batch on ``device``; with ``non_blocking`` the copies from
        pinned memory are queued on the current stream."""
        return _map(self, lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "Batch":
        """The batch in page-locked host memory, from tensors or from the
        numpy arrays of ``to_numpy`` (``DataLoader``'s pin-memory thread
        calls this too)."""
        return _map(self, lambda t: torch.as_tensor(t).pin_memory())

    def to_numpy(self) -> "Batch":
        """The batch with numpy arrays in place of its CPU tensors (no
        copy); ``from_numpy`` reverses it."""
        return _map(self, lambda t: t.numpy())

    def from_numpy(self) -> "Batch":
        return _map(self, torch.as_tensor)

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor of the batch."""
        return _tensors(self)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


def _flatten_fields(obj):
    names = tuple(f.name for f in dataclasses.fields(obj)
                  if getattr(obj, f.name) is not None)
    return [getattr(obj, n) for n in names], names


# the batch and its fields are pytree nodes (their tensors the leaves, a
# None field no leaf), so ``torch.utils._pytree.tree_flatten`` gives the
# flat inputs of an exported serving program and ``tree_unflatten``
# rebuilds the batch inside it
for _cls in (SparseField, DenseField, SequenceDenseField, Batch):
    pytree.register_pytree_node(
        _cls, _flatten_fields,
        lambda values, names, cls=_cls: cls(**dict(zip(names, values))),
        serialized_type_name=f"{_cls.__module__}.{_cls.__qualname__}")


@dataclasses.dataclass
class BatchInfo:
    """Host-side metadata of one batch: ``checkpoint_info`` maps each
    source id to the largest row index the batch holds of it;
    ``reserved`` holds the reserved input columns (Arrow arrays) that
    predict carries to its output."""

    checkpoint_info: Dict[int, int] = dataclasses.field(default_factory=dict)
    data_timestamp: Optional[int] = None
    batch_size: int = 0
    reserved: Dict[str, Any] = dataclasses.field(default_factory=dict)


def pad_jagged_np(
    values: np.ndarray,
    lengths: np.ndarray,
    bucket: Optional[int] = None,
    weights: Optional[np.ndarray] = None,
) -> SparseField:
    """Pad a host jagged array to a bucketed static size (id -1, weight 0)."""
    n = int(values.shape[0])
    cap = bucket if bucket is not None else bucketize_size(n)
    if cap < n:
        raise ValueError(f"bucket {cap} < values {n}")
    pv = np.full((cap,), -1, dtype=np.int32)
    pv[:n] = values
    pw = None
    if weights is not None:
        pw = np.zeros((cap,), dtype=np.float32)
        pw[:n] = weights
        pw = torch.from_numpy(pw)
    return SparseField(values=torch.from_numpy(pv),
                       lengths=torch.from_numpy(lengths.astype(np.int32)),
                       weights=pw)

"""Batch of torch tensors and the padding helpers that shape it.

Counterpart of torcheasyrec_tpu/datasets/utils.py. Shapes stay those of
the JAX package: a sparse feature is either fixed-length
(``values [B, L]``, ``lengths`` None) or jagged (``values [N_pad]`` with
``N_pad`` rounded up to a power of two, ``lengths [B]``); sequence
features are padded to their configured length. Padding ids are -1 and
gather zero rows. Every container moves to a device with ``.to(device)``.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


def bucketize_size(n: int, minimum: int = 16) -> int:
    """Round n up to the next power of two (>= minimum)."""
    m = max(int(n), minimum)
    return 1 << (m - 1).bit_length()


def _to(x: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if x is None else x.to(device, non_blocking=True)


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

    def to(self, device) -> "SparseField":
        return SparseField(_to(self.values, device), _to(self.lengths, device),
                           _to(self.weights, device))


@dataclasses.dataclass
class DenseField:
    """One dense feature: float32 values [B, D]."""

    values: torch.Tensor

    def to(self, device) -> "DenseField":
        return DenseField(_to(self.values, device))


@dataclasses.dataclass
class SequenceDenseField:
    """A per-position dense sequence feature: values [B, L, D], lengths [B]."""

    values: torch.Tensor
    lengths: torch.Tensor

    def to(self, device) -> "SequenceDenseField":
        return SequenceDenseField(_to(self.values, device),
                                  _to(self.lengths, device))


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

    def to(self, device) -> "Batch":
        return Batch(
            {k: v.to(device) for k, v in self.dense_features.items()},
            {k: v.to(device) for k, v in self.sparse_features.items()},
            {k: v.to(device) for k, v in self.sequence_sparse_features.items()},
            {k: v.to(device) for k, v in self.sequence_dense_features.items()},
            {k: _to(v, device) for k, v in self.labels.items()},
            {k: _to(v, device) for k, v in self.sample_weights.items()},
        )


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

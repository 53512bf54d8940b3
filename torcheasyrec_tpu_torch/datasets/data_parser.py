"""DataParser: Arrow columns -> a static-shape Batch of torch tensors.

Counterpart of torcheasyrec_tpu/datasets/data_parser.py, with the same
padded shapes: jagged value counts round up to power-of-two buckets
(``bucketize_size``, ``pad_jagged_np``) and sequences pad to their
configured ``sequence_length`` keeping the most recent steps. Each
feature keeps its own row count: after a negative sampler, the item-side
features hold B + num_sample rows and the others B; labels stay at B.
A label named ``{sequence_name}__{column}`` after a grouped sequence
feature, or a list-valued label, parses as a padded [B, L] float array
(``_parse_jagged_label``: the sequence's delimiter and length, keeping
the last steps). The tensors are built on the CPU; ``Batch.to(device)``
moves them. The JAX parser's vectorised shortcut for plain id columns,
the native FG DAG and INPUT_TILE serving are not ported.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa
import torch

from torcheasyrec_tpu_torch.datasets.utils import (
    Batch,
    DenseField,
    SequenceDenseField,
    SparseField,
    bucketize_size,
    pad_jagged_np,
)
from torcheasyrec_tpu_torch.features.feature import (
    BaseFeature,
    DenseData,
    SequenceDenseData,
    SequenceSparseData,
    SparseData,
)


class DataParser:
    def __init__(
        self,
        features: List[BaseFeature],
        labels: Optional[List[str]] = None,
        sample_weights: Optional[List[str]] = None,
    ) -> None:
        self._features = features
        self._labels = labels or []
        self._sample_weights = sample_weights or []
        # features that produced a multi-valued row once stay jagged, so
        # the batch layout is stable across batches
        self._force_jagged: set = set()
        # labels of a grouped sequence: {label: (delimiter, length)}
        seq_groups: Dict[str, Any] = {}
        for f in features:
            if f.sequence_name and f.sequence_name not in seq_groups:
                seq_groups[f.sequence_name] = (
                    f.sequence_delim or ";", int(f.sequence_length or 0))
        self._label_seq = {
            lbl: seq_groups[lbl.split("__", 1)[0]] for lbl in self._labels
            if "__" in lbl and lbl.split("__", 1)[0] in seq_groups}

    def parse(self, input_data: Dict[str, pa.Array]) -> Dict[str, Any]:
        """Run every feature's parse; returns name -> parsed numpy data."""
        out: Dict[str, Any] = {}
        for feature in self._features:
            out[feature.name] = feature.parse(input_data)
        for label in self._labels:
            if label in input_data:
                arr = _combined(input_data[label])
                if label in self._label_seq or pa.types.is_list(
                        arr.type) or pa.types.is_large_list(arr.type):
                    out[f"__label__{label}"] = _parse_jagged_label(
                        arr, *self._label_seq.get(label, (";", 0)))
                    continue
                out[f"__label__{label}"] = np.nan_to_num(
                    arr.cast(pa.float32(), safe=False).to_numpy(
                        zero_copy_only=False
                    )
                )
        for w in self._sample_weights:
            if w in input_data:
                arr = _combined(input_data[w])
                out[f"__weight__{w}"] = np.nan_to_num(
                    arr.cast(pa.float32(), safe=False).to_numpy(
                        zero_copy_only=False
                    )
                )
        return out

    def to_batch(self, parsed: Dict[str, Any]) -> Batch:
        """Assemble a static-shape Batch from parsed feature data."""
        batch = Batch()
        for feature in self._features:
            data = parsed.get(feature.name)
            if data is None:
                continue
            name = feature.name
            if isinstance(data, SparseData):
                if (
                    name not in self._force_jagged
                    and (data.lengths <= 1).all()
                ):
                    batch.sparse_features[name] = _fixed_single(data)
                else:
                    self._force_jagged.add(name)
                    batch.sparse_features[name] = pad_jagged_np(
                        data.values,
                        data.lengths,
                        bucket=bucketize_size(len(data.values)),
                        weights=data.weights,
                    )
            elif isinstance(data, DenseData):
                batch.dense_features[name] = DenseField(
                    torch.from_numpy(data.values.astype(np.float32, copy=False))
                )
            elif isinstance(data, SequenceSparseData):
                batch.sequence_sparse_features[name] = _pad_sequence_sparse(
                    feature, data
                )
            elif isinstance(data, SequenceDenseData):
                batch.sequence_dense_features[name] = _pad_sequence_dense(
                    feature, data
                )
            else:
                raise TypeError(f"unknown parsed data {type(data)} for {name}")
        for label in self._labels:
            key = f"__label__{label}"
            if key in parsed:
                batch.labels[label] = torch.from_numpy(
                    parsed[key].astype(np.float32)
                )
        for w in self._sample_weights:
            key = f"__weight__{w}"
            if key in parsed:
                batch.sample_weights[w] = torch.from_numpy(
                    parsed[key].astype(np.float32)
                )
        return batch

    def parse_to_batch(self, input_data: Dict[str, pa.Array]) -> Batch:
        return self.to_batch(self.parse(input_data))


def _combined(arr):
    return arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr


def _parse_jagged_label(arr: pa.Array, delim: str = ";",
                        max_len: int = 0) -> np.ndarray:
    """A multi-valued label per row (a list, or ``delim``-joined string)
    -> padded [B, L] float32, keeping the last steps as the sequence
    features do; L is ``max_len``, else the longest row's bucket."""
    if pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type):
        rows = [[] if v is None else [float(x) for x in v]
                for v in arr.to_pylist()]
    else:
        rows = [[float(t) if t else 0.0 for t in s.split(delim)] if s
                else [] for s in arr.cast(pa.string()).to_pylist()]
    if max_len <= 0:
        max_len = bucketize_size(max((len(r) for r in rows), default=1),
                                 minimum=1)
    out = np.zeros((len(rows), max_len), dtype=np.float32)
    for i, r in enumerate(rows):
        take = min(len(r), max_len)
        if take:
            out[i, :take] = r[len(r) - take:]
    return np.nan_to_num(out)


def _fixed_single(data: SparseData) -> SparseField:
    """All-rows-single-valued SparseData -> fixed [B, 1] (missing -> -1)."""
    b = int(data.lengths.shape[0])
    vals = np.full((b, 1), -1, np.int32)
    rows = np.nonzero(data.lengths)[0]
    vals[rows, 0] = data.values.astype(np.int32, copy=False)
    w = None
    if data.weights is not None:
        w = np.zeros((b, 1), np.float32)
        w[rows, 0] = data.weights
        w = torch.from_numpy(w)
    return SparseField(values=torch.from_numpy(vals), weights=w)


def _seq_layout(feature: BaseFeature, seq_lengths: np.ndarray):
    """(padded length, kept steps per row, source row starts)."""
    b = len(seq_lengths)
    max_len = feature.effective_sequence_length
    if max_len <= 0:
        max_len = bucketize_size(int(seq_lengths.max()) if b else 1,
                                 minimum=8)
    take = np.minimum(seq_lengths, max_len).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(seq_lengths)[:-1]]).astype(
        np.int64
    )
    return max_len, take, starts


def _pad_sequence_sparse(
    feature: BaseFeature, data: SequenceSparseData
) -> SparseField:
    """Single-value steps -> ids [B, L]; multi-value steps -> [B, L, K]
    (the embedding group sum-pools the K slots). Padding ids are -1."""
    b = len(data.seq_lengths)
    max_len, take, starts = _seq_layout(feature, data.seq_lengths)
    if bool(np.any(data.lengths > 1)):
        k = bucketize_size(int(data.lengths.max()), minimum=2)
        ids = np.full((b, max_len, k), -1, dtype=np.int32)
        step_starts = np.concatenate([[0], np.cumsum(data.lengths)])
        for i in range(b):
            first = int(starts[i] + data.seq_lengths[i] - take[i])
            for j in range(int(take[i])):
                lo, hi = int(step_starts[first + j]), int(
                    step_starts[first + j + 1]
                )
                cnt = min(hi - lo, k)
                ids[i, j, :cnt] = data.values[lo:lo + cnt]
    else:
        ids = np.full((b, max_len), -1, dtype=np.int32)
        for i in range(b):
            end = int(starts[i] + data.seq_lengths[i])
            ids[i, :take[i]] = data.values[end - take[i]:end]
    return SparseField(values=torch.from_numpy(ids),
                       lengths=torch.from_numpy(take))


def _pad_sequence_dense(
    feature: BaseFeature, data: SequenceDenseData
) -> SequenceDenseField:
    b = len(data.seq_lengths)
    d = data.values.shape[-1] if data.values.ndim > 1 else 1
    max_len, take, starts = _seq_layout(feature, data.seq_lengths)
    out = np.zeros((b, max_len, d), dtype=np.float32)
    vals = data.values.reshape(-1, d)
    for i in range(b):
        end = int(starts[i] + data.seq_lengths[i])
        out[i, :take[i]] = vals[end - take[i]:end]
    return SequenceDenseField(values=torch.from_numpy(out),
                              lengths=torch.from_numpy(take))

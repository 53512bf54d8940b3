"""RawFeature: numeric feature, optionally bucketized into a categorical
or embedded by a dense embedding.

Counterpart of torcheasyrec_tpu/features/raw_feature.py. In FG_NONE mode
boundary-bucketized raw features arrive as bucket ids, so the base
class's parse applies unchanged. In FG_NORMAL mode ``_parse_fg`` reads
numbers (a string cell of ``value_dim`` values split on ``separator``,
a sequence cell on the sequence delimiter first; nulls and empty cells
read ``default_value``), applies the ``normalizer`` and bucketizes by
``boundaries`` where there are some. A raw feature with ``autodis`` or
``mlp`` (``has_dense_embedding``) stays dense in the batch; the
embedding group embeds it (``modules/embedding.py``): AutoDis embeds
each of its ``value_dim`` columns and concatenates them ([B, n * d]),
the MLP embedding projects the vector ([B, d]).
"""

from typing import Any, Dict

import numpy as np
import pyarrow as pa

from torcheasyrec_tpu_torch.features.feature import (
    BaseFeature,
    DenseData,
    SequenceDenseData,
    SequenceSparseData,
    SparseData,
    _parse_fg_encoded_dense,
    _parse_fg_encoded_sequence_dense,
    parse_normalizer,
)


class RawFeature(BaseFeature):
    @property
    def is_sparse(self) -> bool:
        return len(self.config.boundaries) > 0

    @property
    def has_dense_embedding(self) -> bool:
        return self.dense_emb_kind is not None

    @property
    def output_dim(self) -> int:
        if self.is_sparse:
            return int(self.config.embedding_dim)
        if self.has_dense_embedding:
            d = int(self.config.embedding_dim)
            if self.dense_emb_kind == "autodis":
                return d * max(self.value_dim, 1)
            return d
        return max(self.value_dim, 1)

    @property
    def num_embeddings(self) -> int:
        return len(self.config.boundaries) + 1

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        feat = self._input_column(input_data)
        c = self.config
        normalizer = parse_normalizer(getattr(c, "normalizer", ""))
        dim = max(self.value_dim, 1)
        default = [float(getattr(c, "default_value", "0") or 0)] * dim
        sep = getattr(c, "separator", "\x1d")
        if self.is_sequence:
            dd = _parse_fg_encoded_sequence_dense(
                self.name, feat, self.effective_sequence_delim, sep, dim,
                default)
            vals = normalizer(dd.values) if normalizer else dd.values
            if self.is_sparse:
                ids = self._bucketize(vals[:, 0])
                return SequenceSparseData(
                    self.name, ids, np.ones_like(ids, np.int32),
                    dd.seq_lengths)
            return SequenceDenseData(self.name, vals, dd.seq_lengths)
        dd = _parse_fg_encoded_dense(self.name, feat, sep, default)
        vals = normalizer(dd.values) if normalizer else dd.values
        if self.is_sparse:
            ids = self._bucketize(vals[:, 0])
            return SparseData(self.name, ids, np.ones_like(ids, np.int32),
                              None)
        return DenseData(self.name, vals.astype(np.float32))

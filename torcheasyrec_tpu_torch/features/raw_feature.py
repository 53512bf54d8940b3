"""RawFeature: numeric feature, optionally bucketized into a categorical
or embedded by a dense embedding.

Counterpart of torcheasyrec_tpu/features/raw_feature.py. In FG_NONE mode
boundary-bucketized raw features arrive as bucket ids, so the base
class's parse applies unchanged. A raw feature with ``autodis`` or
``mlp`` (``has_dense_embedding``) stays dense in the batch; the
embedding group embeds it (``modules/embedding.py``): AutoDis embeds
each of its ``value_dim`` columns and concatenates them ([B, n * d]),
the MLP embedding projects the vector ([B, d]).
"""

from torcheasyrec_tpu_torch.features.feature import BaseFeature


class RawFeature(BaseFeature):
    @property
    def is_sparse(self) -> bool:
        return len(self.config.boundaries) > 0

    @property
    def has_dense_embedding(self) -> bool:
        return self.config.WhichOneof("dense_emb") is not None

    @property
    def output_dim(self) -> int:
        if self.is_sparse:
            return int(self.config.embedding_dim)
        if self.has_dense_embedding:
            d = int(self.config.embedding_dim)
            if self.config.WhichOneof("dense_emb") == "autodis":
                return d * max(self.value_dim, 1)
            return d
        return max(self.value_dim, 1)

    @property
    def num_embeddings(self) -> int:
        return len(self.config.boundaries) + 1

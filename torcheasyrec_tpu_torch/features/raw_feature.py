"""RawFeature: numeric feature, optionally bucketized into a categorical.

Counterpart of torcheasyrec_tpu/features/raw_feature.py. In FG_NONE mode
boundary-bucketized raw features arrive as bucket ids, so the base
class's parse applies unchanged. Dense embeddings (AutoDis, MLP) are not
ported.
"""

from torcheasyrec_tpu_torch.features.feature import BaseFeature


class RawFeature(BaseFeature):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.config.WhichOneof("dense_emb") is not None:
            raise NotImplementedError(
                f"feature {self.name}: dense embeddings are not ported"
            )

    @property
    def is_sparse(self) -> bool:
        return len(self.config.boundaries) > 0

    @property
    def num_embeddings(self) -> int:
        return len(self.config.boundaries) + 1

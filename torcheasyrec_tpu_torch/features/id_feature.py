"""IdFeature: categorical id feature.

Counterpart of torcheasyrec_tpu/features/id_feature.py. In FG_NONE mode
the ids arrive encoded, so the base class's parse applies unchanged.
"""

from torcheasyrec_tpu_torch.features.feature import BaseFeature


class IdFeature(BaseFeature):
    @property
    def is_sparse(self) -> bool:
        return True

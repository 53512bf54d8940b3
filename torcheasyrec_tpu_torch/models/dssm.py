"""DSSM and DSSMV2: two towers over their own feature groups.

Counterpart of torcheasyrec_tpu/models/dssm.py. The user tower reads
``user_tower.input``, the item tower ``item_tower.input``; each is a
``MatchTower``. DSSMV2 is the same model: the embedding engine already
shares the tables of features with the same ``embedding_name``.
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.match_model import MatchModel


class DSSM(MatchModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._build_embedding_group()
        mc = self._model_config
        eg = self.embedding_group
        self.user_tower = self._match_tower(
            mc.user_tower, eg.group_total_dim(mc.user_tower.input))
        self.item_tower = self._match_tower(
            mc.item_tower, eg.group_total_dim(mc.item_tower.input))

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        return self._two_tower_predict(
            self.predict_tower(grouped, batch, "user"),
            self.predict_tower(grouped, batch, "item"), batch)


class DSSMV2(DSSM):
    pass

"""MaskNet: the MaskNet module over the first feature group, then the
output linear.

Counterpart of torcheasyrec_tpu/models/masknet.py.
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.masknet import masknet_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class MaskNet(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        # the first group, whatever its name, as the JAX package reads it
        self._group = self.embedding_group.group_names()[0]
        self.masknet = masknet_from_config(
            self.embedding_group.group_total_dim(self._group),
            config_to_kwargs(self._model_config.mask_net_module), g)
        self.output = linear(self.masknet.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        h = self.masknet(grouped[self._group], dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))

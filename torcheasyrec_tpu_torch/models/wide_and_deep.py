"""WideAndDeep: the wide group's sum plus a deep MLP, or both through a
final MLP.

Counterpart of torcheasyrec_tpu/models/wide_and_deep.py. Feature groups:
``wide`` (WIDE, tables of ``wide_embedding_dim`` columns) and ``deep``
(DEEP).
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class WideAndDeep(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        self.deep_mlp = mlp_from_config(
            self.embedding_group.group_total_dim("deep"),
            config_to_kwargs(self._model_config.deep), g)
        final_dim = self.deep_mlp.output_dim()
        self.final_mlp = None
        if self._model_config.HasField("final"):
            self.final_mlp = mlp_from_config(
                final_dim + 1, config_to_kwargs(self._model_config.final), g)
            final_dim = self.final_mlp.output_dim()
        self.output = linear(final_dim, self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        y_wide = grouped["wide"].sum(dim=1, keepdim=True)
        y_deep = self.deep_mlp(grouped["deep"], dt)
        if self.final_mlp is not None:
            y_final = self.final_mlp(torch.cat([y_wide, y_deep], dim=1), dt)
            y = linear_apply(self.output, y_final, dt)
        else:
            y = y_wide + linear_apply(self.output, y_deep, dt)
        return self._output_to_prediction(y)

"""DCN v1 and v2.

Counterpart of torcheasyrec_tpu/models/dcn.py. Both read the main group
(``all`` where configured, else the first group). DCNV1: the cross net
and a deep MLP side by side, concatenated into the final MLP. DCNV2,
stacked: an optional backbone MLP, the low-rank cross, an optional deep
MLP, the final MLP.
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.interaction import Cross, CrossV2
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class DCNV1(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        mc = self._model_config
        in_dim = self.embedding_group.group_total_dim(self._main_group())
        self.cross = Cross(in_dim, int(mc.cross.cross_num), g)
        self.deep = mlp_from_config(in_dim, config_to_kwargs(mc.deep), g)
        self.final = mlp_from_config(in_dim + self.deep.output_dim(),
                                     config_to_kwargs(mc.final), g)
        self.output = linear(self.final.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = grouped[self._main_group()]
        h = self.final(torch.cat([self.cross(x), self.deep(x, dt)], dim=1),
                       dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))


class DCNV2(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        mc = self._model_config
        in_dim = self.embedding_group.group_total_dim(self._main_group())
        self.backbone = None
        if mc.HasField("backbone"):
            self.backbone = mlp_from_config(
                in_dim, config_to_kwargs(mc.backbone), g)
            in_dim = self.backbone.output_dim()
        self.cross = CrossV2(in_dim, int(mc.cross.cross_num),
                             int(mc.cross.low_rank), g)
        self.deep = None
        if mc.HasField("deep"):
            self.deep = mlp_from_config(in_dim, config_to_kwargs(mc.deep), g)
            in_dim = self.deep.output_dim()
        self.final = mlp_from_config(in_dim, config_to_kwargs(mc.final), g)
        self.output = linear(self.final.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = grouped[self._main_group()]
        if self.backbone is not None:
            x = self.backbone(x, dt)
        x = self.cross(x, dt)
        if self.deep is not None:
            x = self.deep(x, dt)
        h = self.final(x, dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))

"""DeepFM: wide sum + factorization machine + deep MLP, optional final
MLP.

Counterpart of torcheasyrec_tpu/models/deepfm.py. Feature-group contract
as in the JAX package: ``wide`` (WIDE), ``deep`` (DEEP) and optionally
``fm`` (DEEP, embeddings of one dim; ``deep`` takes its place when
absent).
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.fm import FactorizationMachine
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class DeepFM(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        self.fm = FactorizationMachine()
        self._fm_group = "fm" if eg.has_group("fm") else "deep"
        self._fm_feature_dims = eg.group_dims(self._fm_group)
        if len(set(self._fm_feature_dims)) != 1:
            raise ValueError("fm feature embedding dims must match, got "
                             f"{set(self._fm_feature_dims)}")
        self.deep_mlp = mlp_from_config(
            eg.group_total_dim("deep"),
            config_to_kwargs(self._model_config.deep), g)
        final_dim = self.deep_mlp.output_dim()
        self.final_mlp = None
        if self._model_config.HasField("final"):
            self.final_mlp = mlp_from_config(
                1 + self._fm_feature_dims[0] + final_dim,
                config_to_kwargs(self._model_config.final), g)
            final_dim = self.final_mlp.output_dim()
        self.output = linear(final_dim, self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        y_wide = grouped["wide"].sum(dim=1, keepdim=True)
        y_deep = self.deep_mlp(grouped["deep"], dt)
        fm_feat = grouped[self._fm_group].reshape(
            -1, len(self._fm_feature_dims), self._fm_feature_dims[0])
        y_fm = self.fm(fm_feat)
        if self.final_mlp is not None:
            y_final = self.final_mlp(
                torch.cat([y_wide, y_fm, y_deep], dim=1), dt)
            y = linear_apply(self.output, y_final, dt)
        else:
            y = (y_wide + y_fm.sum(dim=1, keepdim=True)
                 + linear_apply(self.output, y_deep, dt))
        return self._output_to_prediction(y)

"""xDeepFM: CIN over the per-feature embeddings, a deep MLP and the wide
sum, through a final MLP.

Counterpart of torcheasyrec_tpu/models/xdeepfm.py (proto name
``xDeepFM``). CIN reads the ``fm`` group where there is one, else
``deep``; its features must share one dim. Parameters as the JAX tree:
``cin``, ``deep``, ``final``, ``output``.
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.interaction import CIN
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class XDeepFM(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        mc = self._model_config
        self._cin_group = "fm" if eg.has_group("fm") else "deep"
        dims = eg.group_dims(self._cin_group)
        if len(set(dims)) != 1:
            raise ValueError(f"{self._cin_group} embedding dims must match "
                             f"for CIN, got {set(dims)}")
        self._emb_dim, self._num_feats = dims[0], len(dims)
        self.cin = CIN(self._num_feats, list(mc.cin.cin_layer_size), g)
        self.deep = mlp_from_config(eg.group_total_dim("deep"),
                                    config_to_kwargs(mc.deep), g)
        self.final = mlp_from_config(
            1 + self.cin.output_dim() + self.deep.output_dim(),
            config_to_kwargs(mc.final), g)
        self.output = linear(self.final.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        y_wide = grouped["wide"].sum(dim=1, keepdim=True)
        feats = grouped[self._cin_group].reshape(
            -1, self._num_feats, self._emb_dim)
        y_cin = self.cin(feats, dt)
        y_deep = self.deep(grouped["deep"], dt)
        h = self.final(torch.cat([y_wide, y_cin, y_deep], dim=1), dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))

"""WuKong: stacked WuKong layers over the per-feature embeddings, the
dense features optionally through an MLP into more features of the same
dim, then a final MLP.

Counterpart of torcheasyrec_tpu/models/wukong.py. Groups ``sparse``
(embeddings of one dim) and optionally ``dense`` (with ``dense_mlp``,
whose output must be a multiple of that dim). Parameters as the JAX
tree: ``dense_mlp``, ``layers.<i>`` (a JAX list), ``final``, ``output``.
"""

from typing import Dict

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.interaction import WuKongLayer
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class WuKong(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        mc = self._model_config
        dims = eg.group_dims("sparse")
        if len(set(dims)) != 1:
            raise ValueError(f"sparse embedding dims must match, got "
                             f"{set(dims)}")
        self._emb_dim = dims[0]
        num_feats = len(dims)
        self.dense_mlp = None
        if eg.has_group("dense") and mc.HasField("dense_mlp"):
            self.dense_mlp = mlp_from_config(
                eg.group_total_dim("dense"), config_to_kwargs(mc.dense_mlp),
                g)
            if self.dense_mlp.output_dim() % self._emb_dim:
                raise ValueError(
                    f"dense_mlp output {self.dense_mlp.output_dim()} is not "
                    f"a multiple of the embedding dim {self._emb_dim}")
            num_feats += self.dense_mlp.output_dim() // self._emb_dim
        layers, f = [], num_feats
        for lc in mc.wukong_layers:
            cfg = config_to_kwargs(lc)
            layers.append(WuKongLayer(
                num_features=f, emb_dim=self._emb_dim,
                lcb_feature_num=int(cfg["lcb_feature_num"]),
                fmb_feature_num=int(cfg["fmb_feature_num"]),
                compressed_feature_num=int(
                    cfg.get("compressed_feature_num", 16)),
                feature_num_mlp=cfg["feature_num_mlp"], generator=g))
            f = layers[-1].out_features
        self.layers = nn.ModuleList(layers)
        self.final = mlp_from_config(f * self._emb_dim,
                                     config_to_kwargs(mc.final), g)
        self.output = linear(self.final.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = grouped["sparse"]
        b = x.shape[0]
        x = x.reshape(b, -1, self._emb_dim)
        if self.dense_mlp is not None:
            d = self.dense_mlp(grouped["dense"], dt).reshape(
                b, -1, self._emb_dim)
            x = torch.cat([d, x], dim=1)
        for layer in self.layers:
            x = layer(x, dt)
        h = self.final(x.reshape(b, -1), dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))

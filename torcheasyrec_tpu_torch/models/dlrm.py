"""DLRM: a dense MLP to the embedding dim, the dot interaction over
[dense, sparse...] feature vectors, then the final MLP.

Counterpart of torcheasyrec_tpu/models/dlrm.py. Feature groups:
``sparse`` (DEEP, id features of one dim) and optionally ``dense``
(DEEP, raw features only; its MLP must end at the sparse dim). With
``arch_with_sparse`` (the default) the flattened feature vectors join
the interaction's output.
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.interaction import InteractionArch
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class DLRM(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        sparse_dims = eg.group_dims("sparse")
        if len(set(sparse_dims)) != 1:
            raise ValueError("sparse embedding dims must match, got "
                             f"{set(sparse_dims)}")
        self._emb_dim = sparse_dims[0]
        num_feats = len(sparse_dims)
        self.dense_mlp = None
        if eg.has_group("dense"):
            self.dense_mlp = mlp_from_config(
                eg.group_total_dim("dense"),
                config_to_kwargs(self._model_config.dense_mlp), g)
            if self.dense_mlp.output_dim() != self._emb_dim:
                raise ValueError(
                    f"dense_mlp output {self.dense_mlp.output_dim()} must "
                    f"equal the sparse embedding dim {self._emb_dim}")
            num_feats += 1
        self.interaction = InteractionArch(num_feats, g.device)
        self._arch_with_sparse = bool(self._model_config.arch_with_sparse)
        final_in = self.interaction.output_dim()
        if self._arch_with_sparse:
            final_in += num_feats * self._emb_dim
        self.final_mlp = mlp_from_config(
            final_in, config_to_kwargs(self._model_config.final), g)
        self.output = linear(self.final_mlp.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        b = grouped["sparse"].shape[0]
        feats = grouped["sparse"].reshape(b, -1, self._emb_dim)
        if self.dense_mlp is not None:
            d = self.dense_mlp(grouped["dense"], dt)
            feats = torch.cat([d[:, None, :], feats], dim=1)
        inter = self.interaction(feats)
        if self._arch_with_sparse:
            inter = torch.cat([feats.reshape(b, -1), inter], dim=1)
        h = self.final_mlp(inter, dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))

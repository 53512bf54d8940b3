"""MultiTower and MultiTowerDIN.

Counterpart of torcheasyrec_tpu/models/multi_tower.py. One MLP tower per
configured group (``towers.<group>``); MultiTowerDIN adds one DIN tower
per ``din_towers`` entry over a sequence group (``din.<i>``; its query
width defaults to the sequence's). The towers' outputs are concatenated
in that order into the final MLP and the output linear.
"""

from typing import Dict

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.modules.sequence import DINEncoder
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class MultiTower(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        mc = self._model_config
        self.towers = nn.ModuleDict({
            t.input: mlp_from_config(eg.group_total_dim(t.input),
                                     config_to_kwargs(t.mlp), g)
            for t in mc.towers})
        dims = eg.seq_group_dims()
        self.din = nn.ModuleList(
            DINEncoder(
                sequence_dim=dims[f"{t.input}.sequence"],
                query_dim=dims.get(f"{t.input}.query",
                                   dims[f"{t.input}.sequence"]),
                input=t.input, attn_mlp=config_to_kwargs(t.attn_mlp),
                generator=g)
            for t in getattr(mc, "din_towers", ()))
        total = (sum(m.output_dim() for m in self.towers.values())
                 + sum(enc.output_dim() for enc in self.din))
        self.final = mlp_from_config(total, config_to_kwargs(mc.final), g)
        self.output = linear(self.final.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        outs = [mlp(grouped[name], dt) for name, mlp in self.towers.items()]
        outs += [enc(grouped, dt) for enc in self.din]
        h = self.final(torch.cat(outs, dim=1), dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))


class MultiTowerDIN(MultiTower):
    """MultiTower with the DIN towers of ``din_towers``."""

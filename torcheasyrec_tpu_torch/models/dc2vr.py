"""DC2VR: a shared bottom (optional MLP and MMoE), one MLP tower per task,
and interventions: a tower with ``intervention_tower_names`` moves its
hidden state by a low-rank map of those towers' hidden states (detached)
under a gate.

Counterpart of torcheasyrec_tpu/models/dc2vr.py. Parameters as the JAX
tree: ``bottom``, ``mmoe``, and per tower name ``towers.<name>``,
``interventions.<name>``, ``outputs.<name>``.
"""

from typing import Dict

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.multi_task_rank import MultiTaskRank
from torcheasyrec_tpu_torch.modules.intervention import Intervention
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.mmoe import MMoE as MMoEModule
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class DC2VR(MultiTaskRank):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        mc = self._model_config
        dim = self.embedding_group.group_total_dim(self._main_group())
        self.bottom = self.mmoe = None
        if mc.HasField("bottom_mlp"):
            self.bottom = mlp_from_config(
                dim, config_to_kwargs(mc.bottom_mlp), g)
            dim = self.bottom.output_dim()
        if mc.HasField("expert_mlp"):
            self.mmoe = MMoEModule(
                in_features=dim,
                expert_mlp=config_to_kwargs(mc.expert_mlp),
                num_expert=int(mc.num_expert),
                num_task=len(self._task_tower_cfgs),
                generator=g,
                gate_mlp=(config_to_kwargs(mc.gate_mlp)
                          if mc.HasField("gate_mlp") else None),
            )
            dim = self.mmoe.output_dim()
        self.towers = nn.ModuleDict()
        hidden = {}
        for t in self._task_tower_cfgs:
            hidden[t.tower_name] = dim
            if t.HasField("mlp"):
                self.towers[t.tower_name] = mlp_from_config(
                    dim, config_to_kwargs(t.mlp), g)
                hidden[t.tower_name] = self.towers[t.tower_name].output_dim()
        self.interventions = nn.ModuleDict()
        self.outputs = nn.ModuleDict()
        for t in self._task_tower_cfgs:
            name = t.tower_name
            if len(t.intervention_tower_names):
                self.interventions[name] = Intervention(
                    hidden[name],
                    sum(hidden[r] for r in t.intervention_tower_names),
                    int(t.low_rank_dim), g, float(t.dropout_ratio))
            self.outputs[name] = linear(hidden[name], int(t.num_class), g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = grouped[self._main_group()]
        if self.bottom is not None:
            x = self.bottom(x, dt)
        task_inputs = (self.mmoe(x, dt) if self.mmoe is not None
                       else [x] * len(self._task_tower_cfgs))
        hidden = {}
        for t, h in zip(self._task_tower_cfgs, task_inputs):
            if t.tower_name in self.towers:
                h = self.towers[t.tower_name](h, dt)
            hidden[t.tower_name] = h
        preds = {}
        for t in self._task_tower_cfgs:
            name = t.tower_name
            h = hidden[name]
            if name in self.interventions:
                cond = torch.cat([hidden[r].detach()
                                  for r in t.intervention_tower_names],
                                 dim=-1)
                h = self.interventions[name](h, cond, dt)
            preds.update(self._task_output_to_prediction(
                t, linear_apply(self.outputs[name], h, dt)))
        return preds

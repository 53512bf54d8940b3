"""MMoE: the main group through shared experts and per-task gates, then
one MLP tower per task.

Counterpart of torcheasyrec_tpu/models/mmoe.py.
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.multi_task_rank import MultiTaskRank
from torcheasyrec_tpu_torch.modules.mmoe import MMoE as MMoEModule
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class MMoE(MultiTaskRank):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        mc = self._model_config
        self.mmoe = MMoEModule(
            in_features=self.embedding_group.group_total_dim(
                self._main_group()),
            expert_mlp=config_to_kwargs(mc.expert_mlp),
            num_expert=int(mc.num_expert),
            num_task=len(self._task_tower_cfgs),
            generator=self._generator,
            gate_mlp=(config_to_kwargs(mc.gate_mlp)
                      if mc.HasField("gate_mlp") else None),
        )
        self._task_towers(self.mmoe.output_dim())

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        return self._towers_predict(
            self.mmoe(grouped[self._main_group()], self.compute_dtype))

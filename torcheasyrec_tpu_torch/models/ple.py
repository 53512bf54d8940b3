"""PLE: stacked extraction networks (CGC layers), then one MLP tower per
task.

Counterpart of torcheasyrec_tpu/models/ple.py. Parameters:
``extraction.<l>`` (JAX ``extraction`` list), ``towers.<t>``,
``outputs.<t>``.
"""

from typing import Dict

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.multi_task_rank import MultiTaskRank
from torcheasyrec_tpu_torch.modules.extraction_net import ExtractionNet
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class PLE(MultiTaskRank):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        in_dim = self.embedding_group.group_total_dim(self._main_group())
        num_task = len(self._task_tower_cfgs)
        task_dims, share_dim = [in_dim] * num_task, in_dim
        nets = list(self._model_config.extraction_networks)
        self.extraction = nn.ModuleList()
        for li, en_cfg in enumerate(nets):
            cfg = config_to_kwargs(en_cfg)
            net = ExtractionNet(
                in_task=task_dims,
                in_share=share_dim,
                num_task=num_task,
                expert_num_per_task=int(cfg["expert_num_per_task"]),
                share_num=int(cfg.get("share_num", 1) or 1),
                task_expert_net=cfg["task_expert_net"],
                generator=self._generator,
                share_expert_net=cfg.get("share_expert_net"),
                final_flag=li == len(nets) - 1,
            )
            self.extraction.append(net)
            task_dims = [net.task_output_dim()] * num_task
            share_dim = net.share_output_dim() or share_dim
        self._task_towers(task_dims[0])

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        x = grouped[self._main_group()]
        task_inputs, share = [x] * len(self._task_tower_cfgs), x
        for net in self.extraction:
            task_inputs, share = net(task_inputs, share, self.compute_dtype)
        return self._towers_predict(task_inputs)

"""PLE extraction network (CGC layer): per-task experts and shared
experts, mixed per task by gates over its own and the shared experts;
unless it is the last layer, a shared gate over all experts feeds the
next layer's shared input.

Counterpart of torcheasyrec_tpu/modules/extraction_net.py. Parameters:
``task_experts.<t>.<i>``, ``share_experts.<i>`` (MLPs), ``gates.<t>``
and ``share_gate`` (linears); the mix is ``mmoe.gate_mix``.
"""

from typing import List, Optional, Tuple

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.mmoe import gate_mix
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply


class ExtractionNet(nn.Module):
    def __init__(
        self,
        in_task: List[int],
        in_share: int,
        num_task: int,
        expert_num_per_task: int,
        share_num: int,
        task_expert_net: dict,
        generator: torch.Generator,
        share_expert_net: Optional[dict] = None,
        final_flag: bool = False,
    ) -> None:
        super().__init__()
        self.num_task = num_task
        self.final_flag = final_flag
        self.task_experts = nn.ModuleList(
            nn.ModuleList(mlp_from_config(in_task[t], task_expert_net,
                                          generator)
                          for _ in range(expert_num_per_task))
            for t in range(num_task))
        n_share = (max(share_num, 1)
                   if (share_expert_net or share_num) else 0)
        self.share_experts = nn.ModuleList(
            mlp_from_config(in_share, share_expert_net or task_expert_net,
                            generator)
            for _ in range(n_share))
        self.gates = nn.ModuleList(
            linear(in_task[t], expert_num_per_task + n_share, generator)
            for t in range(num_task))
        self.share_gate = None
        if n_share and not final_flag:
            self.share_gate = linear(
                in_share, num_task * expert_num_per_task + n_share, generator)
        self._task_out = self.task_experts[0][0].output_dim()
        self._share_out = (self.share_experts[0].output_dim()
                           if n_share else 0)

    def task_output_dim(self) -> int:
        return self._task_out

    def share_output_dim(self) -> int:
        return self._share_out

    def forward(self, task_inputs: List[torch.Tensor],
                share_input: torch.Tensor, compute_dtype: torch.dtype
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        per_task = [[e(task_inputs[t], compute_dtype) for e in experts]
                    for t, experts in enumerate(self.task_experts)]
        share = [e(share_input, compute_dtype) for e in self.share_experts]
        new_task_inputs = [
            gate_mix(linear_apply(self.gates[t], task_inputs[t],
                                  compute_dtype),
                     torch.stack(per_task[t] + share, dim=1))
            for t in range(self.num_task)
        ]
        new_share = share_input
        if self.share_gate is not None:
            options = torch.stack(
                [o for outs in per_task for o in outs] + share, dim=1)
            new_share = gate_mix(
                linear_apply(self.share_gate, share_input, compute_dtype),
                options)
        return new_task_inputs, new_share

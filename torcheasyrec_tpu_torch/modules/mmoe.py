"""MMoE: shared experts mixed per task by softmax gates.

Counterpart of torcheasyrec_tpu/modules/mmoe.py. Each gate's logits are
a linear in the compute dtype, the softmax runs in fp32 and is cast to
the experts' dtype before the mix, as in the JAX package. Parameters:
``experts.<i>`` (MLPs) and ``gates.<t>`` with ``linear`` and, when the
config has a gate MLP, ``mlp``.
"""

from typing import List, Optional

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply


def gate_mix(gate_logits: torch.Tensor,
             options: torch.Tensor) -> torch.Tensor:
    """softmax(logits) in fp32, cast to the options' dtype, then the
    weighted sum of the options: [B, E] x [B, E, D] -> [B, D]."""
    gate = torch.softmax(gate_logits.float(), dim=-1).to(options.dtype)
    return torch.einsum("be,bed->bd", gate, options)


class Gate(nn.Module):
    def __init__(self, in_features: int, num_expert: int,
                 generator: torch.Generator,
                 gate_mlp: Optional[dict] = None) -> None:
        super().__init__()
        self.mlp = (mlp_from_config(in_features, gate_mlp, generator)
                    if gate_mlp else None)
        gate_in = self.mlp.output_dim() if self.mlp else in_features
        self.linear = linear(gate_in, num_expert, generator)


class MMoE(nn.Module):
    def __init__(self, in_features: int, expert_mlp: dict, num_expert: int,
                 num_task: int, generator: torch.Generator,
                 gate_mlp: Optional[dict] = None) -> None:
        super().__init__()
        self.experts = nn.ModuleList(
            mlp_from_config(in_features, expert_mlp, generator)
            for _ in range(num_expert))
        self.gates = nn.ModuleList(
            Gate(in_features, num_expert, generator, gate_mlp)
            for _ in range(num_task))
        self._out = self.experts[0].output_dim()

    def output_dim(self) -> int:
        return self._out

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> List[torch.Tensor]:
        expert_out = torch.stack([e(x, compute_dtype) for e in self.experts],
                                 dim=1)
        outs = []
        for gate in self.gates:
            g_in = gate.mlp(x, compute_dtype) if gate.mlp is not None else x
            outs.append(gate_mix(
                linear_apply(gate.linear, g_in, compute_dtype), expert_out))
        return outs

"""DC2VR's intervention: a tower's representation moved by a low-rank
map of other towers' representations under a gate.

Counterpart of torcheasyrec_tpu/modules/intervention.py: out = main +
sigmoid(gate(cond)) * up(down(cond)), then dropout. Parameters ``down``
and ``up`` (no bias) and ``gate``.
"""

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.module import (
    dropout,
    linear,
    linear_apply,
)


class Intervention(nn.Module):
    def __init__(self, main_dim: int, cond_dim: int, low_rank_dim: int,
                 generator: torch.Generator,
                 dropout_ratio: float = 0.1) -> None:
        super().__init__()
        self._generator = generator
        self.dropout_ratio = dropout_ratio
        self.down = linear(cond_dim, low_rank_dim, generator, bias=False)
        self.up = linear(low_rank_dim, main_dim, generator, bias=False)
        self.gate = linear(cond_dim, main_dim, generator)

    def forward(self, main: torch.Tensor, cond: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        delta = linear_apply(
            self.up, linear_apply(self.down, cond, compute_dtype),
            compute_dtype)
        gate = torch.sigmoid(linear_apply(self.gate, cond, compute_dtype))
        return dropout(main + gate * delta, self.dropout_ratio,
                       self.training, self._generator)

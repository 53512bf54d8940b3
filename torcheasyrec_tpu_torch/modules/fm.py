"""Factorization machine.

Counterpart of torcheasyrec_tpu/modules/fm.py: the second-order
interaction 0.5 * ((sum v)^2 - sum v^2) over per-feature embeddings.
"""

import torch
from torch import nn


class FactorizationMachine(nn.Module):
    """Input [B, F, D] -> [B, D]. No parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sum_sq = x.sum(dim=1).square()
        sq_sum = x.square().sum(dim=1)
        return 0.5 * (sum_sq - sq_sum)

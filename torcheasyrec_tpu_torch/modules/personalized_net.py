"""PEPNet's blocks: GateNU, EPNet (the embedding personalisation gate)
and PPNet (parameter-personalised towers).

Counterpart of torcheasyrec_tpu/modules/personalized_net.py. Parameter
names follow the JAX tree: ``gate.l1``/``gate.l2`` (EPNet),
``layers.<i>`` and ``gates.<i>`` (PPNet's JAX lists). The gates read
their shared input detached, as the JAX package's stop-gradients do.
"""

from typing import Sequence

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.activation import get_activation
from torcheasyrec_tpu_torch.modules.module import (
    dropout,
    linear,
    linear_apply,
)


class GateNU(nn.Module):
    """gamma * sigmoid(l2(relu(l1(x))))."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 generator: torch.Generator, gamma: float = 2.0) -> None:
        super().__init__()
        self.gamma = gamma
        self.l1 = linear(in_dim, hidden_dim, generator)
        self.l2 = linear(hidden_dim, out_dim, generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        h = torch.relu(linear_apply(self.l1, x, compute_dtype))
        return self.gamma * torch.sigmoid(
            linear_apply(self.l2, h, compute_dtype))


class EPNet(nn.Module):
    """Scales the shared embedding by a gate over [domain, embedding]."""

    def __init__(self, feature_dim: int, domain_dim: int, hidden_dim: int,
                 generator: torch.Generator, gamma: float = 2.0) -> None:
        super().__init__()
        self.gate = GateNU(domain_dim + feature_dim,
                           hidden_dim or feature_dim, feature_dim, generator,
                           gamma)

    def forward(self, features: torch.Tensor, domain_emb: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        gate_in = torch.cat([domain_emb, features.detach()], dim=-1)
        return features * self.gate(gate_in, compute_dtype)


class PPNet(nn.Module):
    """A task's MLP whose every layer output is scaled by a gate over
    [prior, input]."""

    def __init__(self, in_dim: int, prior_dim: int,
                 hidden_units: Sequence[int], generator: torch.Generator,
                 activation: str = "nn.ReLU",
                 dropout_ratio: Sequence[float] = (),
                 gamma: float = 2.0) -> None:
        super().__init__()
        self._generator = generator
        self.hidden_units = list(hidden_units)
        self.act = get_activation(activation)
        dr = list(dropout_ratio)
        self.dropout_ratio = dr + [0.0] * (len(self.hidden_units) - len(dr))
        dims = [in_dim] + self.hidden_units
        self._out = dims[-1]
        self.layers = nn.ModuleList(
            linear(dims[i], h, generator)
            for i, h in enumerate(self.hidden_units))
        self.gates = nn.ModuleList(
            GateNU(prior_dim + in_dim, h, h, generator, gamma)
            for h in self.hidden_units)

    def output_dim(self) -> int:
        return self._out

    def forward(self, x: torch.Tensor, prior: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        gate_in = torch.cat([prior, x.detach()], dim=-1)
        h = x
        for layer, gate, dr in zip(self.layers, self.gates,
                                   self.dropout_ratio):
            h = self.act(linear_apply(layer, h, compute_dtype))
            h = h * gate(gate_in, compute_dtype)
            h = dropout(h, dr, self.training, self._generator)
        return h

"""Variational dropout over the features of one group, for feature
importance.

Counterpart of torcheasyrec_tpu/modules/variational_dropout.py: one
learnable drop logit per feature (or per embedding lane with
``embedding_wise``), init -2. In training a concrete (gumbel-sigmoid,
temperature 0.1) keep gate from noise ``u`` in (1e-6, 1 - 1e-6), one
draw per logit and step, scales each feature's lanes; in eval the keep
probability 1 - p does. The regularisation term is lambda * sum(1 - p).
``u`` is drawn from the caller's generator unless it is given, so that
two devices, or two packages, can be fed the same draws.
"""

from typing import List, Optional, Tuple

import torch
from torch import nn

_U_LOW = 1e-6
_TEMPERATURE = 0.1


def draw_noise(n: int, generator: torch.Generator) -> torch.Tensor:
    """n uniform draws in (1e-6, 1 - 1e-6) from ``generator``, on its
    device."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (1.0 - 2.0 * _U_LOW) + _U_LOW


class VariationalDropout(nn.Module):
    def __init__(self, feature_dims: List[int],
                 regularization_lambda: float = 0.01,
                 embedding_wise: bool = False, device=None) -> None:
        super().__init__()
        self.feature_dims = list(feature_dims)
        self.lam = regularization_lambda
        self.embedding_wise = embedding_wise
        self.n = sum(feature_dims) if embedding_wise else len(feature_dims)
        self.logit_p = nn.Parameter(torch.full((self.n,), -2.0,
                                               device=device))
        self.register_buffer(
            "_lanes", torch.repeat_interleave(
                torch.arange(len(feature_dims), device=device),
                torch.tensor(feature_dims, device=device)),
            persistent=False)

    def forward(self, x: torch.Tensor, training: bool,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, sum(dims)] -> (gated x, regularisation term)."""
        p = torch.sigmoid(self.logit_p)  # drop probability
        if training:
            if u is None:
                if generator is None:
                    raise ValueError("variational dropout in training mode "
                                     "needs a generator or given noise")
                u = draw_noise(self.n, generator)
            z = torch.sigmoid(
                (torch.log(1 - p + 1e-9) - torch.log(p + 1e-9)
                 + torch.log(u) - torch.log(1 - u)) / _TEMPERATURE)
        else:
            z = 1.0 - p
        if not self.embedding_wise:
            z = z[self._lanes]
        return x * z.to(x.dtype)[None, :], self.lam * torch.sum(1.0 - p)

    def drop_probabilities(self) -> torch.Tensor:
        """Per logit drop probability, for feature selection."""
        return torch.sigmoid(self.logit_p.detach())

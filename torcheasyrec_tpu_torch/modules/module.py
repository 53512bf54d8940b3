"""Linear, layer-norm and dropout semantics of the dense stack.

Counterpart of torcheasyrec_tpu/modules/module.py. Parameters live in
fp32 ``nn.Module``s and are cast at use: ``linear_apply`` multiplies in
the compute dtype (bf16 when the config sets ``mixed_precision: "BF16"``,
else fp32), accumulates in fp32, adds the fp32 bias and casts the result
to the compute dtype, as the JAX package's ``linear_apply`` does. In
bf16, cuBLAS rounds its fp32 sums to bf16 before the bias is added, one
rounding more than the JAX path. Casts are explicit; there is no
``torch.autocast``. Initializers draw from an explicit
``torch.Generator``; they follow the JAX package's distributions, not
its numbers. Dropout draws from the same kind of generator.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(in_dim: int, out_dim: int, generator: torch.Generator,
           bias: bool = True) -> nn.Linear:
    """nn.Linear initialized uniform(+-1/sqrt(in_dim)), weight and bias,
    as the JAX package's ``linear_init``."""
    layer = nn.Linear(in_dim, out_dim, bias=bias, device=generator.device)
    bound = 1.0 / (in_dim ** 0.5)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear_apply(layer: nn.Linear, x: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """y = x W^T + b in ``compute_dtype`` with an fp32 accumulator."""
    y = F.linear(x.to(compute_dtype), layer.weight.to(compute_dtype)).float()
    if layer.bias is not None:
        y = y + layer.bias
    return y.to(compute_dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input's dtype."""

    def __init__(self, dim: int, device=None, eps: float = 1e-5) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


def dropout_keep_mask(shape, p: float, device,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bool mask that keeps each entry with probability 1 - p, drawn from
    ``generator`` (which lives on ``device``)."""
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    return torch.rand(shape, device=device, generator=generator) < 1.0 - p


def apply_dropout(x: torch.Tensor, keep: torch.Tensor,
                  p: float) -> torch.Tensor:
    """Kept entries scaled by 1 / (1 - p), the others zero."""
    return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as the JAX package's ``dropout``: the identity in
    eval or at p <= 0."""
    if not training or p <= 0.0:
        return x
    return apply_dropout(
        x, dropout_keep_mask(x.shape, p, x.device, generator), p)

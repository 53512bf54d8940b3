"""MLP stack: per layer Linear -> [LayerNorm] -> activation -> dropout.

Counterpart of torcheasyrec_tpu/modules/mlp.py. Batch norm is not
ported. Dropout is the identity in eval and raises in training mode.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.activation import get_activation
from torcheasyrec_tpu_torch.modules.module import (
    LayerNorm,
    check_no_training,
    linear,
    linear_apply,
)


class Perceptron(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator,
                 bias: bool, use_ln: bool) -> None:
        super().__init__()
        self.linear = linear(in_dim, out_dim, generator, bias)
        self.ln = LayerNorm(out_dim, generator.device) if use_ln else None


class MLP(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_units: Sequence[int],
        generator: torch.Generator,
        activation: str = "nn.ReLU",
        use_bn: bool = False,
        use_ln: bool = False,
        dropout_ratio: Optional[Sequence[float]] = None,
        bias: bool = True,
    ) -> None:
        super().__init__()
        if use_bn:
            raise NotImplementedError("MLP batch norm is not ported")
        self.in_features = in_features
        self.hidden_units = list(hidden_units)
        self.act = get_activation(activation)
        dr = list(dropout_ratio or [])
        if len(dr) == 1 and len(self.hidden_units) > 1:
            dr = dr * len(self.hidden_units)
        self.dropout_ratio = dr + [0.0] * (len(self.hidden_units) - len(dr))
        dims = [in_features] + self.hidden_units
        self.layers = nn.ModuleList(
            Perceptron(dims[i], dims[i + 1], generator, bias, use_ln)
            for i in range(len(self.hidden_units))
        )

    def output_dim(self) -> int:
        return self.hidden_units[-1] if self.hidden_units else self.in_features

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        for layer, dr in zip(self.layers, self.dropout_ratio):
            check_no_training(self, dr)
            x = linear_apply(layer.linear, x, compute_dtype)
            if layer.ln is not None:
                x = layer.ln(x)
            x = self.act(x)
        return x


def mlp_from_config(in_features: int, cfg: dict,
                    generator: torch.Generator) -> MLP:
    """Build an MLP from a config_to_kwargs dict of the MLP proto."""
    return MLP(
        in_features=in_features,
        hidden_units=cfg.get("hidden_units", []),
        generator=generator,
        activation=cfg.get("activation", "nn.ReLU"),
        use_bn=cfg.get("use_bn", False),
        use_ln=cfg.get("use_ln", False),
        dropout_ratio=cfg.get("dropout_ratio", []),
        bias=cfg.get("bias", True),
    )

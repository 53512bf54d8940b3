"""MLP stack: per layer Linear -> [BatchNorm] -> [LayerNorm] ->
activation -> dropout.

Counterpart of torcheasyrec_tpu/modules/mlp.py. Per layer ``layers.<i>``
holds ``linear``, ``bn`` (``use_bn``: ``module.BatchNorm``, its running
statistics buffers), ``ln`` (``use_ln``) and ``act`` where the
activation has parameters (Dice, PReLU). Dropout is the identity in eval
and draws its mask from the module's generator in training mode.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.activation import (
    act_needs_params,
    create_activation,
    get_activation,
)
from torcheasyrec_tpu_torch.modules.module import (
    BatchNorm,
    LayerNorm,
    dropout,
    linear,
    linear_apply,
)


class Perceptron(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator,
                 bias: bool, use_bn: bool, use_ln: bool,
                 activation: str) -> None:
        super().__init__()
        dev = generator.device
        self.linear = linear(in_dim, out_dim, generator, bias)
        self.bn = BatchNorm(out_dim, dev) if use_bn else None
        self.ln = LayerNorm(out_dim, dev) if use_ln else None
        self.act = create_activation(activation, out_dim, dev)


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
        self._generator = generator
        self.in_features = in_features
        self.hidden_units = list(hidden_units)
        self.act = (None if act_needs_params(activation)
                    else get_activation(activation))
        dr = list(dropout_ratio or [])
        if len(dr) == 1 and len(self.hidden_units) > 1:
            dr = dr * len(self.hidden_units)
        self.dropout_ratio = dr + [0.0] * (len(self.hidden_units) - len(dr))
        dims = [in_features] + self.hidden_units
        self.layers = nn.ModuleList(
            Perceptron(dims[i], dims[i + 1], generator, bias, use_bn, use_ln,
                       activation)
            for i in range(len(self.hidden_units))
        )

    def output_dim(self) -> int:
        return self.hidden_units[-1] if self.hidden_units else self.in_features

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        for layer, dr in zip(self.layers, self.dropout_ratio):
            x = linear_apply(layer.linear, x, compute_dtype)
            if layer.bn is not None:
                x = layer.bn(x)
            if layer.ln is not None:
                x = layer.ln(x)
            x = self.act(x) if layer.act is None else layer.act(x)
            x = dropout(x, dr, self.training, self._generator)
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

"""Activations by config name, Dice and PReLU included.

Counterpart of torcheasyrec_tpu/modules/activation.py. Accepts
torch-style ("nn.ReLU") and jax-style ("relu") names. The parameter-free
activations are functions (``get_activation``); Dice and PReLU hold
per-channel parameters and are modules (``create_activation``), which an
MLP keeps under ``layers.<i>.act`` as the JAX package keeps them under
``layer_<i>.act``.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.modules.module import BatchNorm

_SIMPLE = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "mish": F.mish,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def normalize_act_name(name: Optional[str]) -> str:
    if not name:
        return "identity"
    # "nn.ReLU" / "torch.nn.ReLU" / "ReLU" / "Dice(dim=64)" -> "relu"
    return name.strip().rsplit(".", 1)[-1].split("(", 1)[0].lower()


def act_needs_params(name: Optional[str]) -> bool:
    return normalize_act_name(name) in ("dice", "prelu")


def get_activation(name: Optional[str]) -> Callable:
    """The parameter-free activation of that name; Dice and PReLU need
    ``create_activation``."""
    n = normalize_act_name(name)
    fn = _SIMPLE.get(n)
    if fn is None:
        if n in ("dice", "prelu"):
            raise ValueError(f"activation {name} has parameters; build it "
                             "with create_activation")
        raise ValueError(f"unknown activation {name}")
    return fn


class PReLU(nn.Module):
    """max(x, 0) + alpha * min(x, 0) with one ``alpha`` per channel
    (init 0.25; ``nn.PReLU`` keeps one scalar)."""

    def __init__(self, dim: int, device=None) -> None:
        super().__init__()
        self.alpha = nn.Parameter(torch.full((dim,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x).to(x.dtype)


class Dice(nn.Module):
    """Dice (the DIN paper): p = sigmoid(BN(x)), y = p x + (1 - p) alpha x,
    ``alpha`` zeros per channel, the BN over every leading axis."""

    def __init__(self, dim: int, device=None) -> None:
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim, device=device))
        self.bn = BatchNorm(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.bn(x))
        return (p * x + (1.0 - p) * self.alpha * x).to(x.dtype)


def create_activation(name: Optional[str], dim: int,
                      device=None) -> Optional[nn.Module]:
    """Dice or PReLU over ``dim`` channels; None for the parameter-free
    activations."""
    n = normalize_act_name(name)
    if n == "dice":
        return Dice(dim, device)
    if n == "prelu":
        return PReLU(dim, device)
    return None

"""Activations by config name.

Counterpart of torcheasyrec_tpu/modules/activation.py for the
parameter-free activations. Accepts torch-style ("nn.ReLU") and
jax-style ("relu") names. Dice and PReLU are not ported.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F

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


def get_activation(name: Optional[str]) -> Callable:
    n = normalize_act_name(name)
    fn = _SIMPLE.get(n)
    if fn is None:
        raise NotImplementedError(f"activation {name} is not ported")
    return fn

"""Linear, layer-norm, batch-norm and dropout semantics of the dense
stack.

Counterpart of torcheasyrec_tpu/modules/module.py. Parameters live in
fp32 ``nn.Module``s and are cast at use: ``linear_apply`` multiplies in
the compute dtype (bf16 or fp16 when the config sets ``mixed_precision:
"BF16"`` or ``"FP16"``, else fp32), accumulates in fp32, adds the fp32
bias and casts the result to the compute dtype, as the JAX package's
``linear_apply`` does. In bf16 and fp16 the product rounds its fp32 sums
to the compute dtype before the bias is added, one rounding more than
the JAX path. Casts are explicit; there is no
``torch.autocast``. Initializers draw from an explicit
``torch.Generator``; they follow the JAX package's distributions, not
its numbers (``parse_init_fn`` reads the torch-style init strings of the
configs, ``default_emb_init`` is the tables' default). Dropout draws
from the same kind of generator.
"""

from typing import Callable, Optional

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


class BatchNorm(nn.Module):
    """Batch norm over every leading axis, as the JAX package's
    ``batch_norm_apply``: in training the biased batch statistics of the
    input in fp32 normalise it, and the running ``mean`` and ``var``
    (buffers, no optimizer sees them) move by ``momentum`` towards them,
    the biased variance included, once per training forward; in eval the
    running statistics normalise it. The result is cast back to the
    input's dtype. A [B, L, D] input keeps [D] statistics (padded
    positions included), unlike ``nn.BatchNorm1d``."""

    def __init__(self, dim: int, device=None, momentum: float = 0.1,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(xf, dim=axes, correction=0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


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


InitFn = Callable[[torch.Tensor, torch.Generator, int], None]


def parse_init_fn(spec: Optional[str]) -> Optional[InitFn]:
    """``fn(view, generator, fan_rows)`` filling ``view`` in place from a
    torch-style init string such as ``"nn.init.uniform_,a=-0.01,b=0.01"``;
    None for an empty string. The port's copy of the JAX package's
    ``parse_init_fn``, with its semantics: ``trunc_normal`` draws a plain
    normal, and the fan-based inits take ``fan_in`` = the table's rows
    (``fan_rows``) and ``fan_out`` = the view's last dimension."""
    if not spec:
        return None
    parts = [p.strip() for p in spec.split(",")]
    name = parts[0].rsplit(".", 1)[-1].rstrip("_")
    kwargs = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            try:
                kwargs[k.strip()] = float(v)
            except ValueError:
                kwargs[k.strip()] = v.strip()

    a, b = kwargs.get("a", 0.0), kwargs.get("b", 1.0)
    mean, std = kwargs.get("mean", 0.0), kwargs.get("std", 1.0)
    val = kwargs.get("val", 0.0)
    # name -> fill(view, generator, fan_in, fan_out)
    fills = {
        "uniform": lambda v, g, fi, fo: v.uniform_(a, b, generator=g),
        "normal": lambda v, g, fi, fo: v.normal_(mean, std, generator=g),
        "constant": lambda v, g, fi, fo: v.fill_(val),
        "zeros": lambda v, g, fi, fo: v.fill_(0.0),
        "ones": lambda v, g, fi, fo: v.fill_(1.0),
        "xavier_uniform": lambda v, g, fi, fo: v.uniform_(
            -(6.0 / (fi + fo)) ** 0.5, (6.0 / (fi + fo)) ** 0.5, generator=g),
        "xavier_normal": lambda v, g, fi, fo: v.normal_(
            0.0, (2.0 / (fi + fo)) ** 0.5, generator=g),
        "kaiming_uniform": lambda v, g, fi, fo: v.uniform_(
            -(6.0 / fi) ** 0.5, (6.0 / fi) ** 0.5, generator=g),
        "kaiming_normal": lambda v, g, fi, fo: v.normal_(
            0.0, (2.0 / fi) ** 0.5, generator=g),
    }
    fills.update(trunc_normal=fills["normal"],
                 glorot_uniform=fills["xavier_uniform"],
                 glorot_normal=fills["xavier_normal"],
                 he_uniform=fills["kaiming_uniform"],
                 he_normal=fills["kaiming_normal"])
    if name not in fills:
        raise ValueError(f"unknown init fn {spec}")
    fill = fills[name]

    def _init(view: torch.Tensor, generator: torch.Generator,
              fan_rows: int) -> None:
        fill(view, generator, fan_rows, view.shape[-1])

    return _init


def default_emb_init(view: torch.Tensor, generator: torch.Generator,
                     fan_rows: int) -> None:
    """The tables' default: uniform(+-1/sqrt(rows)) of the whole table."""
    bound = 1.0 / max(fan_rows, 1) ** 0.5
    view.uniform_(-bound, bound, generator=generator)

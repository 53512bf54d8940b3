"""Feature-interaction modules: the DLRM dot interaction and the DCN
cross layers.

Counterpart of ``InteractionArch``, ``Cross`` and ``CrossV2`` in
torcheasyrec_tpu/modules/interaction.py, with its dtype rules: the dot
interaction sums in fp32 and casts back to the input's dtype; the v1
cross layer's fp32 weight promotes a bf16 input to fp32 (as jnp's
promotion does); the v2 layers are linears in the compute dtype. CIN,
WuKong and InputSENet are not ported.
"""

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.module import linear, linear_apply


class InteractionArch(nn.Module):
    """DLRM dot interaction: input [B, F, D] -> the F (F - 1) / 2 dots of
    distinct feature pairs, [B, F (F - 1) / 2], in the upper triangle's
    row-major order. No parameters."""

    def __init__(self, num_features: int, device=None) -> None:
        super().__init__()
        self.f = num_features
        rows, cols = torch.triu_indices(num_features, num_features, 1,
                                        device=device)
        self.register_buffer("_tri", rows * num_features + cols,
                             persistent=False)

    def output_dim(self) -> int:
        return self.f * (self.f - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # products of bf16 values are exact in fp32: the fp32 batched
        # product is the JAX package's fp32-accumulated einsum
        xf = x.float()
        dots = torch.bmm(xf, xf.transpose(1, 2)).flatten(1)
        # index_select's backward is one index_add_; advanced indexing's
        # sorts the indices on every step
        return dots.index_select(1, self._tri).to(x.dtype)


class CrossLayer(nn.Module):
    """One DCN v1 layer's parameters: ``weight`` and ``bias``, both [D]."""

    def __init__(self, dim: int, generator: torch.Generator) -> None:
        super().__init__()
        w = torch.randn(dim, generator=generator, device=generator.device)
        self.weight = nn.Parameter(w * dim ** -0.5)
        self.bias = nn.Parameter(torch.zeros(dim, device=generator.device))


class Cross(nn.Module):
    """DCN v1 cross layers: x_{l+1} = x0 * (w_l . x_l) + b_l + x_l."""

    def __init__(self, in_features: int, cross_num: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.dim = in_features
        self.layers = nn.ModuleList(
            CrossLayer(in_features, generator) for _ in range(cross_num))

    def output_dim(self) -> int:
        return self.dim

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in self.layers:
            xw = (x * layer.weight).sum(dim=-1, keepdim=True)
            x = x0 * xw + layer.bias + x
        return x


class CrossV2Layer(nn.Module):
    """One DCN v2 layer: ``v`` [D -> r] without bias, ``u`` [r -> D]."""

    def __init__(self, dim: int, low_rank: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.u = linear(low_rank, dim, generator)
        self.v = linear(dim, low_rank, generator, bias=False)


class CrossV2(nn.Module):
    """DCN v2 low-rank cross: x_{l+1} = x0 * (U_l (V_l^T x_l) + b_l) + x_l,
    the linears in ``compute_dtype``."""

    def __init__(self, in_features: int, cross_num: int, low_rank: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.dim = in_features
        self.layers = nn.ModuleList(
            CrossV2Layer(in_features, low_rank, generator)
            for _ in range(cross_num))

    def output_dim(self) -> int:
        return self.dim

    def forward(self, x0: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        x = x0
        for layer in self.layers:
            low = linear_apply(layer.v, x, compute_dtype)
            x = x0 * linear_apply(layer.u, low, compute_dtype) + x
        return x

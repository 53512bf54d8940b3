"""Feature-interaction modules: the DLRM dot interaction, the DCN cross
layers, InputSENet, xDeepFM's CIN and the WuKong blocks.

Counterpart of torcheasyrec_tpu/modules/interaction.py, with its dtype
rules: the dot interaction sums in fp32 and casts back to the input's
dtype; the v1 cross layer's fp32 weight promotes a bf16 input to fp32
(as jnp's promotion does); the v2 layers are linears in the compute
dtype. CIN and the WuKong blocks mix features through [in, out] weights
cast to the compute dtype, batched matmuls with fp32 accumulation whose
result is cast to the input's dtype, as the JAX package's einsums with
``preferred_element_type=float32``. Their weights keep the JAX layout
([in, out], ``w`` named ``weight``).
"""

from typing import Dict, List, Sequence

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import (
    LayerNorm,
    linear,
    linear_apply,
)


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


def _scaled_normal(rows: int, cols: int,
                   generator: torch.Generator) -> nn.Parameter:
    """[rows, cols] from N(0, 1 / rows), the JAX package's init of the
    feature maps."""
    w = torch.randn(rows, cols, generator=generator, device=generator.device)
    return nn.Parameter(w * rows ** -0.5)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the two operands' promoted dtype (16-bit products sum in
    fp32 and round once)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def mix_features(x: torch.Tensor, weight: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """einsum("bfd,fk->bkd", x, weight) with the weight in
    ``compute_dtype``, cast to x's dtype."""
    out = _product(x.transpose(1, 2), weight.to(compute_dtype))
    return out.transpose(1, 2).to(x.dtype)


class InputSENet(nn.Module):
    """Squeeze-excitation over per-feature embeddings (FiBiNET): each
    feature scaled by 2 sigmoid(w2 relu(w1 z)), z the features' means.
    No JAX model wires it."""

    def __init__(self, field_dims: Sequence[int], generator: torch.Generator,
                 reduction_ratio: int = 2) -> None:
        super().__init__()
        self.field_dims = list(field_dims)
        f = len(self.field_dims)
        self.hidden = max(f // reduction_ratio, 1)
        self.w1 = linear(f, self.hidden, generator, bias=False)
        self.w2 = linear(self.hidden, f, generator, bias=False)

    def forward(self, x_list: List[torch.Tensor],
                compute_dtype: torch.dtype) -> List[torch.Tensor]:
        z = torch.stack([x.mean(dim=-1) for x in x_list], dim=-1)  # [B, F]
        a = torch.relu(linear_apply(self.w1, z, compute_dtype))
        a = 2.0 * torch.sigmoid(linear_apply(self.w2, a, compute_dtype))
        return [x * a[:, i:i + 1] for i, x in enumerate(x_list)]


class CINLayer(nn.Module):
    """One CIN layer's map from the H_prev x F outer products to H
    features: ``weight`` [H_prev F, H]."""

    def __init__(self, rows: int, cols: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.weight = _scaled_normal(rows, cols, generator)


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM): input [B, F, D]; layer k
    maps the outer products of X^{k-1} [B, H_{k-1}, D] and X^0 along the
    features, [B, H_{k-1} F, D], to X^k [B, H_k, D]; the output is every
    layer's sum over D, [B, sum H_k]. Computed in a [B, D, ...] layout, so
    that each layer's map is one GEMM of (B D) rows."""

    def __init__(self, num_features: int, cin_layer_size: Sequence[int],
                 generator: torch.Generator) -> None:
        super().__init__()
        self.f = num_features
        self.sizes = list(cin_layer_size)
        dims = [num_features] + self.sizes
        self.layers = nn.ModuleList(
            CINLayer(dims[i] * num_features, h, generator)
            for i, h in enumerate(self.sizes))

    def output_dim(self) -> int:
        return sum(self.sizes)

    def forward(self, x0: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        x0t = x0.transpose(1, 2)  # [B, D, F]
        xk, outs = x0t, []
        for layer in self.layers:
            # [B, D, H_prev F], index h F + f as the JAX package's reshape
            z = (xk[..., :, None] * x0t[..., None, :]).flatten(2)
            xk = _product(z, layer.weight.to(compute_dtype)).to(x0.dtype)
            outs.append(xk.sum(dim=1))  # [B, H]
        return torch.cat(outs, dim=-1)


class LinearCompressBlock(nn.Module):
    """WuKong's LCB: F features to K by a learned ``weight`` [F, K]; also
    the WuKong layer's residual projection."""

    def __init__(self, num_features: int, out_features: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.weight = _scaled_normal(num_features, out_features, generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        return mix_features(x, self.weight, compute_dtype)


class FactorizationMachineBlock(nn.Module):
    """WuKong's FMB: the features against C compressed ones
    (``compress`` [F, C]), [B, F, C], through ``mlp`` and the linear
    ``out`` to K features of D."""

    def __init__(self, num_features: int, emb_dim: int, out_features: int,
                 compressed_num: int, mlp_cfg: Dict,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.d, self.k = emb_dim, out_features
        self.compress = _scaled_normal(num_features, compressed_num,
                                       generator)
        self.mlp = mlp_from_config(num_features * compressed_num, mlp_cfg,
                                   generator)
        self.out = linear(self.mlp.output_dim(), out_features * emb_dim,
                          generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        b = x.shape[0]
        compressed = mix_features(x, self.compress, compute_dtype)
        fm = _product(x, compressed.transpose(1, 2)).to(x.dtype)  # [B, F, C]
        h = self.mlp(fm.reshape(b, -1), compute_dtype)
        return linear_apply(self.out, h, compute_dtype).reshape(
            b, self.k, self.d)


class WuKongLayer(nn.Module):
    """One WuKong layer: LayerNorm(concat(FMB, LCB) + residual), the
    residual projected to the layer's feature count where it differs."""

    def __init__(self, num_features: int, emb_dim: int, lcb_feature_num: int,
                 fmb_feature_num: int, compressed_feature_num: int,
                 feature_num_mlp: Dict, generator: torch.Generator) -> None:
        super().__init__()
        self.out_features = lcb_feature_num + fmb_feature_num
        self.lcb = LinearCompressBlock(num_features, lcb_feature_num,
                                       generator)
        self.fmb = FactorizationMachineBlock(
            num_features, emb_dim, fmb_feature_num, compressed_feature_num,
            feature_num_mlp, generator)
        self.ln = LayerNorm(emb_dim, generator.device)
        self.residual_proj = (
            LinearCompressBlock(num_features, self.out_features, generator)
            if self.out_features != num_features else None)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        out = torch.cat([self.fmb(x, compute_dtype),
                         self.lcb(x, compute_dtype)], dim=1)
        res = (x if self.residual_proj is None
               else self.residual_proj(x, compute_dtype))
        return self.ln(out + res)

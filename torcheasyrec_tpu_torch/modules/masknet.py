"""MaskNet: instance-guided masks over layer-normed feature embeddings,
parallel or serial mask blocks, then an optional top MLP.

Counterpart of torcheasyrec_tpu/modules/masknet.py (``MaskBlock``,
``MaskNetModule``). Parameter names follow the JAX tree: ``ln_in``,
``blocks.<i>`` (JAX ``block_<i>``) with ``agg``, ``mask``, ``hidden``
and ``ln``, and ``top``.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import (
    LayerNorm,
    linear,
    linear_apply,
)


class MaskBlock(nn.Module):
    """relu(LN(hidden(x * mask(relu(agg(mask_input))))))."""

    def __init__(self, input_dim: int, mask_input_dim: int, hidden_dim: int,
                 generator: torch.Generator, aggregation_dim: int = 0,
                 reduction_ratio: float = 1.0) -> None:
        super().__init__()
        self.hidden_dim = hidden_dim
        agg_dim = aggregation_dim or int(mask_input_dim * reduction_ratio)
        self.agg = linear(mask_input_dim, agg_dim, generator)
        self.mask = linear(agg_dim, input_dim, generator)
        self.hidden = linear(input_dim, hidden_dim, generator)
        self.ln = LayerNorm(hidden_dim, generator.device)

    def output_dim(self) -> int:
        return self.hidden_dim

    def forward(self, x: torch.Tensor, mask_input: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        a = F.relu(linear_apply(self.agg, mask_input, compute_dtype))
        mask = linear_apply(self.mask, a, compute_dtype)
        hidden = linear_apply(self.hidden, x * mask, compute_dtype)
        return F.relu(self.ln(hidden))


class MaskNetModule(nn.Module):
    """Parallel: every block masks LN(x) by x and the outputs are
    concatenated. Serial: each block masks the previous block's output
    (the first LN(x)) by x."""

    def __init__(self, feature_dim: int, n_mask_blocks: int, mask_block: dict,
                 generator: torch.Generator, top_mlp: Optional[dict] = None,
                 use_parallel: bool = True) -> None:
        super().__init__()
        self.use_parallel = use_parallel
        hidden_dim = int(mask_block["hidden_dim"])
        agg = int(mask_block.get("aggregation_dim", 0) or 0)
        rr = float(mask_block.get("reduction_ratio", 1.0))
        self.ln_in = LayerNorm(feature_dim, generator.device)
        blocks = []
        in_dim = feature_dim
        for _ in range(n_mask_blocks):
            blocks.append(MaskBlock(in_dim, feature_dim, hidden_dim,
                                    generator, agg, rr))
            if not use_parallel:
                in_dim = hidden_dim
        self.blocks = nn.ModuleList(blocks)
        top_in = hidden_dim * n_mask_blocks if use_parallel else hidden_dim
        self.top = mlp_from_config(top_in, top_mlp, generator) if top_mlp \
            else None
        self._out = self.top.output_dim() if self.top else top_in

    def output_dim(self) -> int:
        return self._out

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        xn = self.ln_in(x)
        if self.use_parallel:
            h = torch.cat([blk(xn, x, compute_dtype) for blk in self.blocks],
                          dim=-1)
        else:
            h = xn
            for blk in self.blocks:
                h = blk(h, x, compute_dtype)
        if self.top is not None:
            h = self.top(h, compute_dtype)
        return h


def masknet_from_config(feature_dim: int, cfg: dict,
                        generator: torch.Generator) -> MaskNetModule:
    """Build a MaskNetModule from a config_to_kwargs dict of its proto."""
    return MaskNetModule(
        feature_dim=feature_dim,
        n_mask_blocks=int(cfg["n_mask_blocks"]),
        mask_block=cfg["mask_block"],
        generator=generator,
        top_mlp=cfg.get("top_mlp"),
        use_parallel=bool(cfg.get("use_parallel", True)),
    )

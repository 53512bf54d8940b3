"""STU layer and stack: the HSTU transformer core, forward only.

Counterpart of torcheasyrec_tpu/modules/gr/stu.py (STULayer, STUStack).
Per layer: LayerNorm -> fused uvqk projection (SiLU on u) -> pointwise
SiLU attention (the CUDA kernel on the card) -> Norm(attn) * u -> output
projection -> residual. The KV-cached decode (``cached_forward``) and
``truncate_uih`` are not ported.
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.module import LayerNorm, check_no_training
from torcheasyrec_tpu_torch.ops import Kernel
from torcheasyrec_tpu_torch.ops.hstu import (
    hstu_compute_output,
    hstu_compute_uqvk,
    hstu_mha,
)


class STULayer(nn.Module):
    def __init__(
        self,
        embedding_dim: int,
        linear_hidden_dim: int,
        attention_dim: int,
        generator: torch.Generator,
        num_heads: int = 1,
        max_attn_len: int = 0,
        output_dropout_ratio: float = 0.0,
        use_group_norm: bool = False,
        attn_alpha: float = 0.0,
        contextual_seq_len: int = 0,
        kernel: Kernel = Kernel.PALLAS,
        sla_k1: int = 0,
        sla_k2: int = 0,
    ) -> None:
        super().__init__()
        dev = generator.device
        e, h, ld, ad = embedding_dim, num_heads, linear_hidden_dim, attention_dim
        self.h, self.ld, self.ad = h, ld, ad
        self.max_attn_len = max_attn_len
        self.dropout = output_dropout_ratio
        self.use_group_norm = use_group_norm
        self.alpha = attn_alpha or (attention_dim ** -0.5)
        self.contextual_seq_len = contextual_seq_len
        self.kernel = kernel
        self.sla_k1 = sla_k1
        self.sla_k2 = sla_k2
        uvqk_out = h * ld * 2 + h * ad * 2
        self.input_ln = LayerNorm(e, dev)
        # [out, in] like nn.Linear; the JAX package keeps [in, out]
        self.uvqk_weight = nn.Parameter(torch.randn(
            uvqk_out, e, generator=generator, device=dev) * (e ** -0.5))
        self.uvqk_bias = nn.Parameter(torch.zeros(uvqk_out, device=dev))
        self.output_ln = LayerNorm(h * ld, dev)
        self.output_weight = nn.Parameter(torch.randn(
            e, h * ld, generator=generator, device=dev) * ((h * ld) ** -0.5))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                num_targets: Optional[torch.Tensor] = None,
                scaling_seqlen: int = -1) -> torch.Tensor:
        check_no_training(self, self.dropout)
        u, v, q, k = hstu_compute_uqvk(
            x, self.input_ln.weight, self.input_ln.bias, self.uvqk_weight,
            self.uvqk_bias, self.h, self.ld, self.ad,
        )
        attn = hstu_mha(
            q, k, v, lengths,
            alpha=self.alpha,
            causal=True,
            num_targets=num_targets,
            max_attn_len=self.max_attn_len,
            contextual_seq_len=self.contextual_seq_len,
            scaling_seqlen=scaling_seqlen,
            kernel=self.kernel,
            sla_k1=self.sla_k1,
            sla_k2=self.sla_k2,
        )
        return hstu_compute_output(
            attn, u, x, self.output_ln.weight, self.output_ln.bias,
            self.output_weight, group_norm=self.use_group_norm,
            num_heads=self.h, linear_dim=self.ld,
        )


class STUStack(nn.Module):
    def __init__(self, layers) -> None:
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def set_contextual_seq_len(self, n: int) -> None:
        for layer in self.layers:
            layer.contextual_seq_len = n

    def forward(self, x, lengths, num_targets=None, scaling_seqlen: int = -1):
        for layer in self.layers:
            x = layer(x, lengths, num_targets, scaling_seqlen)
        return x


def stu_from_config(cfg: Dict[str, Any], generator: torch.Generator,
                    kernel=Kernel.PALLAS) -> STUStack:
    """Build from the STU proto's config_to_kwargs dict (module.proto STU)."""
    return STUStack([
        STULayer(
            embedding_dim=int(cfg["embedding_dim"]),
            linear_hidden_dim=int(cfg["hidden_dim"]),
            attention_dim=int(cfg["attention_dim"]),
            generator=generator,
            num_heads=int(cfg.get("num_heads", 1) or 1),
            max_attn_len=int(cfg.get("max_attn_len", 0) or 0),
            output_dropout_ratio=float(cfg.get("output_dropout_ratio", 0.0)),
            use_group_norm=bool(cfg.get("use_group_norm", False)),
            attn_alpha=float(cfg.get("attn_alpha", 0.0) or 0.0),
            # < 0 = derive from the input preprocessor
            contextual_seq_len=max(
                int(cfg.get("contextual_seq_len", 0) or 0), 0
            ),
            kernel=kernel,
            sla_k1=int(cfg.get("sla_k1", 0) or 0),
            sla_k2=int(cfg.get("sla_k2", 0) or 0),
        )
        for _ in range(int(cfg.get("num_layers", 1) or 1))
    ])

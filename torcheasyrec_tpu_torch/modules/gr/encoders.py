"""GR encoders: action encoder, positional encoder, output postprocessor.

Counterpart of torcheasyrec_tpu/modules/gr/encoders.py.
"""

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.modules.module import LayerNorm, linear, linear_apply


class SimpleActionEncoder(nn.Module):
    """Bitmask action weights -> one embedding per set action, or zeros."""

    def __init__(
        self,
        action_embedding_dim: int,
        action_weights: List[int],
        generator: torch.Generator,
        watchtime_to_action_thresholds: Optional[List[int]] = None,
        embedding_init_std: float = 0.1,
    ) -> None:
        super().__init__()
        self.d = action_embedding_dim
        self.action_weights = list(action_weights)
        self.wt_thresholds = list(watchtime_to_action_thresholds or [])
        self.num_actions = len(self.action_weights) + len(self.wt_thresholds)
        self.emb = nn.Parameter(torch.randn(
            self.num_actions, self.d, generator=generator,
            device=generator.device,
        ) * embedding_init_std)

    def output_dim(self) -> int:
        return self.d * self.num_actions

    def forward(self, action_weights: torch.Tensor,
                watchtimes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, N] packed bitmask -> fp32 [B, N, num_actions * d]."""
        aw = action_weights.to(torch.int32)
        flags = [(aw & w) > 0 for w in self.action_weights]
        if self.wt_thresholds and watchtimes is not None:
            wt = watchtimes.to(torch.int32)
            flags += [wt >= t for t in self.wt_thresholds]
        elif self.wt_thresholds:
            flags += [torch.zeros_like(aw, dtype=torch.bool)
                      for _ in self.wt_thresholds]
        onehot = torch.stack(flags, dim=-1).float()  # [B, N, A]
        out = onehot[..., None] * self.emb  # [B, N, A, d]
        return out.reshape(*aw.shape, -1)


class PositionalEncoder(nn.Module):
    """Learned position embeddings, counted back from the sequence end,
    plus log2-bucketed time-delta embeddings."""

    def __init__(self, embedding_dim: int, num_position_buckets: int,
                 generator: torch.Generator, num_time_buckets: int = 0,
                 use_time_encoding: bool = True) -> None:
        super().__init__()
        dev = generator.device
        self.pos_buckets = num_position_buckets
        self.time_buckets = num_time_buckets
        self.use_time = use_time_encoding and num_time_buckets > 0
        self.pos = nn.Parameter(torch.randn(
            num_position_buckets, embedding_dim, generator=generator,
            device=dev) * 0.02)
        self.time = nn.Parameter(torch.randn(
            num_time_buckets, embedding_dim, generator=generator,
            device=dev) * 0.02) if self.use_time else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                timestamps: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        pos = torch.arange(n, device=x.device)[None, :]
        rel = (lengths.long()[:, None] - 1 - pos).clamp(0, self.pos_buckets - 1)
        # F.embedding, not self.pos[rel]: the backward of an advanced index
        # serializes over duplicate indices, and a few time buckets hold
        # almost every token
        out = x + F.embedding(rel, self.pos).to(x.dtype)
        if self.use_time and timestamps is not None:
            ts = timestamps.float()
            last_idx = (lengths.long() - 1).clamp(min=0)
            last_ts = torch.gather(ts, 1, last_idx[:, None])
            delta = (last_ts - ts).clamp(min=0.0)
            bucket = torch.floor(torch.log2(delta + 1.0)).to(torch.int32)
            bucket = bucket.clamp(0, self.time_buckets - 1).long()
            out = out + F.embedding(bucket, self.time).to(x.dtype)
        return out


class OutputPostprocessor(nn.Module):
    """l2_norm | layer_norm | timestamp_layer_norm."""

    def __init__(self, kind: str, embedding_dim: int,
                 generator: torch.Generator,
                 time_period_units: Optional[List[int]] = None) -> None:
        super().__init__()
        if kind not in ("l2_norm", "layer_norm", "timestamp_layer_norm"):
            raise NotImplementedError(f"postprocessor {kind} is not ported")
        self.kind = kind
        self.time_units = list(time_period_units or [3600, 86400])
        self.ln = None
        self.time_mlp = None
        if kind != "l2_norm":
            self.ln = LayerNorm(embedding_dim, generator.device)
        if kind == "timestamp_layer_norm":
            self.time_mlp = linear(2 * len(self.time_units), embedding_dim,
                                   generator)

    def forward(self, x: torch.Tensor, timestamps: Optional[torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        if self.kind == "l2_norm":
            return x * torch.rsqrt(
                x.float().square().sum(-1, keepdim=True) + 1e-12
            ).to(x.dtype)
        y = self.ln(x)
        if self.time_mlp is not None and timestamps is not None:
            ts = timestamps.float()
            feats = []
            for unit in self.time_units:
                phase = 2 * math.pi * torch.remainder(ts, unit) / unit
                feats += [torch.sin(phase), torch.cos(phase)]
            tfeat = torch.stack(feats, dim=-1)
            y = y + linear_apply(self.time_mlp, tfeat, compute_dtype).to(y.dtype)
        return y

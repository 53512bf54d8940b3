"""HSTUTransducer: preprocess -> STU stack -> postprocess.

Counterpart of torcheasyrec_tpu/modules/gr/hstu_transducer.py. The
combined [contextual | uih | candidates] sequence is one gather with
per-sample index arithmetic, so each sample's tokens are contiguous and
"valid = position < length" holds for the attention masks. In training
mode the preprocessor drops input tokens' features with
``input_dropout_ratio``. Attention truncation
(``attn_truncation_split_layer`` > 0), the content/action-MLP
preprocessors (and the contextual dropout inside their parameterized
MLP) and ``cached_forward`` are not ported.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from torcheasyrec_tpu_torch.modules.gr.encoders import (
    OutputPostprocessor,
    PositionalEncoder,
    SimpleActionEncoder,
)
from torcheasyrec_tpu_torch.modules.gr.stu import STUStack
from torcheasyrec_tpu_torch.modules.module import (
    dropout,
    linear,
    linear_apply,
)


def _compact_index(total: int, n_ctx: int, lu_max: int,
                   uih_lengths: torch.Tensor) -> torch.Tensor:
    lu = uih_lengths.long()[:, None]
    j = torch.arange(total, device=uih_lengths.device)[None, :]
    idx = torch.where(j < n_ctx + lu, j, j - lu + lu_max)
    return idx.clamp(0, total - 1)


def compact_concat(
    sources: torch.Tensor,  # [B, n_ctx + Lu + Lc, D] (ctx | uih | cand)
    n_ctx: int,
    lu_max: int,
    uih_lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Per-sample contiguous [ctx, uih[:lu], cand] via one gather."""
    idx = _compact_index(sources.shape[1], n_ctx, lu_max, uih_lengths)
    return torch.gather(
        sources, 1, idx[..., None].expand(-1, -1, sources.shape[2])
    )


def compact_concat_2d(sources: torch.Tensor, n_ctx: int, lu_max: int,
                      uih_lengths: torch.Tensor) -> torch.Tensor:
    """compact_concat for [B, n_ctx + Lu + Lc] per-token scalars."""
    idx = _compact_index(sources.shape[1], n_ctx, lu_max, uih_lengths)
    return torch.gather(sources, 1, idx)


def extract_candidates(
    seq_out: torch.Tensor,  # [B, N, D]
    n_ctx: int,
    uih_lengths: torch.Tensor,
    lc_max: int,
) -> torch.Tensor:
    """Gather the candidate positions' outputs -> [B, Lc, D]."""
    lu = uih_lengths.long()[:, None]
    c = torch.arange(lc_max, device=seq_out.device)[None, :]
    idx = (n_ctx + lu + c).clamp(0, seq_out.shape[1] - 1)
    return torch.gather(
        seq_out, 1, idx[..., None].expand(-1, -1, seq_out.shape[2])
    )


class ContextualPreprocessor(nn.Module):
    """Projects contextual / uih / candidate inputs to E-dim tokens and
    assembles the combined sequence (the linear-projection variant; the
    content/action-MLP family is not ported)."""

    def __init__(
        self,
        embedding_dim: int,
        uih_content_dim: int,
        cand_content_dim: int,
        generator: torch.Generator,
        contextual_dim: int = 0,
        n_contextual_tokens: int = 1,
        action_encoder: Optional[SimpleActionEncoder] = None,
        input_dropout_ratio: float = 0.0,
    ) -> None:
        super().__init__()
        self._generator = generator
        self.e = embedding_dim
        self.n_ctx = n_contextual_tokens if contextual_dim > 0 else 0
        self.dropout = input_dropout_ratio
        uih_in = uih_content_dim + (
            action_encoder.output_dim() if action_encoder else 0
        )
        self.uih_proj = linear(uih_in, embedding_dim, generator)
        self.cand_proj = linear(cand_content_dim, embedding_dim, generator)
        self.ctx_proj = (
            linear(contextual_dim, self.n_ctx * embedding_dim, generator)
            if self.n_ctx else None
        )
        self.action = action_encoder

    def forward(
        self,
        uih_emb: torch.Tensor,  # [B, Lu, uih_dim]
        uih_lengths: torch.Tensor,
        cand_emb: torch.Tensor,  # [B, Lc, cand_dim]
        cand_lengths: torch.Tensor,
        compute_dtype: torch.dtype,
        contextual_emb: Optional[torch.Tensor] = None,  # [B, ctx_dim]
        action_weights: Optional[torch.Tensor] = None,  # [B, Lu]
        watchtimes: Optional[torch.Tensor] = None,
        uih_timestamps: Optional[torch.Tensor] = None,  # [B, Lu]
        cand_timestamps: Optional[torch.Tensor] = None,  # [B, Lc]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Optional[torch.Tensor]]:
        """-> (x [B, N, E], lengths [B], num_targets [B], timestamps)."""
        b, lu_max, _ = uih_emb.shape
        lc_max = cand_emb.shape[1]
        uih_in = uih_emb
        if self.action is not None and action_weights is not None:
            act = self.action(action_weights, watchtimes)
            uih_in = torch.cat([uih_emb, act.to(uih_emb.dtype)], dim=-1)
        pieces = [
            linear_apply(self.uih_proj, uih_in, compute_dtype),
            linear_apply(self.cand_proj, cand_emb, compute_dtype),
        ]
        if self.n_ctx and contextual_emb is not None:
            ctx_tok = linear_apply(self.ctx_proj, contextual_emb,
                                   compute_dtype)
            pieces.insert(0, ctx_tok.reshape(b, self.n_ctx, self.e))
        x = compact_concat(torch.cat(pieces, dim=1), self.n_ctx, lu_max,
                           uih_lengths)
        x = dropout(x, self.dropout, self.training, self._generator)
        lengths = (self.n_ctx + uih_lengths.to(torch.int32)
                   + cand_lengths.to(torch.int32))
        timestamps = None
        if uih_timestamps is not None:
            cand_ts = (
                cand_timestamps.float() if cand_timestamps is not None
                else uih_timestamps.new_zeros((b, lc_max), dtype=torch.float32)
            )
            ts_src = torch.cat([
                uih_timestamps.new_zeros((b, self.n_ctx), dtype=torch.float32),
                uih_timestamps.float(), cand_ts,
            ], dim=1)
            timestamps = compact_concat_2d(ts_src, self.n_ctx, lu_max,
                                           uih_lengths)
        return x, lengths, cand_lengths.to(torch.int32), timestamps


class HSTUTransducer(nn.Module):
    def __init__(
        self,
        preprocessor: ContextualPreprocessor,
        stack: STUStack,
        positional_encoder: Optional[PositionalEncoder] = None,
        postprocessor: Optional[OutputPostprocessor] = None,
        max_seq_len: int = 0,
    ) -> None:
        super().__init__()
        self.pre = preprocessor
        self.stack = stack
        self.pos = positional_encoder
        self.post = postprocessor
        self.max_seq_len = max_seq_len

    def forward(self, compute_dtype: torch.dtype, **inputs
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (seq_out [B, N, E], lengths, num_targets)."""
        x, lengths, num_targets, timestamps = self.pre(
            compute_dtype=compute_dtype, **inputs
        )
        if self.pos is not None:
            x = self.pos(x, lengths, timestamps)
        # the attention scale is the configured max_seq_len, not N
        scaling = self.max_seq_len or x.shape[1]
        x = self.stack(x, lengths, num_targets, scaling_seqlen=scaling)
        if self.post is not None:
            x = self.post(x, timestamps, compute_dtype)
        return x, lengths, num_targets

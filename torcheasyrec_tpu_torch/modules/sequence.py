"""Sequence encoders: DIN, SimpleAttention, Pooling, SelfAttention and
MultiWindowDIN.

Counterpart of torcheasyrec_tpu/modules/sequence.py. An encoder reads
the assembled group dict's ``{input}.query`` [B, Dq],
``{input}.sequence`` [B, L, Ds] and ``{input}.sequence_length`` [B]
and returns [B, D_out] in the sequence's dtype. Everything is masked
dense math over the padded [B, L, D] tensors; padding positions score
``-(2**31) + 1`` before the softmax, which is taken in fp32, as in the
JAX package. Encoders are ``nn.Module``s whose parameters are dense
parameters of the model; SelfAttention's dropout draws from the
module's generator.
"""

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import dropout, linear, linear_apply
from torcheasyrec_tpu_torch.utils.load_class import get_register_class_meta

_SEQ_ENCODER_CLASS_MAP: Dict[str, type] = {}
_meta = get_register_class_meta(_SEQ_ENCODER_CLASS_MAP)

_NEG_PAD = -(2.0 ** 31) + 1


class SequenceEncoder(nn.Module, metaclass=_meta):
    def __init__(self, input: str, max_seq_length: int = 0) -> None:
        super().__init__()
        self.input = input
        self._max_seq_length = max_seq_length

    def output_dim(self) -> int:
        raise NotImplementedError

    def _inputs(self, group: Dict[str, torch.Tensor]):
        """(sequence [B, L, D], lengths [B]), both cut to
        ``max_seq_length`` where it is set."""
        sequence = group[f"{self.input}.sequence"]
        lengths = group[f"{self.input}.sequence_length"]
        if self._max_seq_length > 0:
            lengths = lengths.clamp(max=self._max_seq_length)
            sequence = sequence[:, :self._max_seq_length, :]
        return sequence, lengths


def _valid(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, L] bool: position < length."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths.long()[:, None])


def _mask_scores(scores: torch.Tensor, lengths: torch.Tensor,
                 max_len: int) -> torch.Tensor:
    return torch.where(_valid(lengths, max_len), scores,
                       scores.new_full((), _NEG_PAD))


def _weighted_sum(scores: torch.Tensor, sequence: torch.Tensor
                  ) -> torch.Tensor:
    """sum_l scores[b, l] sequence[b, l, :] in the sequence's dtype."""
    return torch.bmm(scores.to(sequence.dtype)[:, None, :], sequence)[:, 0]


class _AttentionMLP(SequenceEncoder):
    """The MLP over [q, s, q - s, q * s] and the linear to one score per
    position, shared by DIN and MultiWindowDIN; a query narrower than the
    sequence is zero-padded."""

    def __init__(self, sequence_dim: int, query_dim: int, input: str,
                 attn_mlp: Dict[str, Any], generator: torch.Generator,
                 max_seq_length: int = 0) -> None:
        super().__init__(input, max_seq_length)
        self._query_dim = query_dim
        self._sequence_dim = sequence_dim
        self.mlp = mlp_from_config(sequence_dim * 4, attn_mlp, generator)
        self.linear = linear(self.mlp.output_dim(), 1, generator)

    def _scores(self, query: torch.Tensor, sequence: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        """[B, L] scores in ``compute_dtype``."""
        if self._query_dim < self._sequence_dim:
            query = F.pad(query, (0, self._sequence_dim - self._query_dim))
        queries = query[:, None, :].expand_as(sequence)
        attn_in = torch.cat([queries, sequence, queries - sequence,
                             queries * sequence], dim=-1)
        h = self.mlp(attn_in, compute_dtype)
        return linear_apply(self.linear, h, compute_dtype)[..., 0]


class DINEncoder(_AttentionMLP):
    """Target attention: the masked fp32 softmax of the attention MLP's
    scores weights the sequence."""

    def __init__(self, sequence_dim: int, query_dim: int, input: str,
                 attn_mlp: Dict[str, Any], generator: torch.Generator,
                 max_seq_length: int = 0, **kwargs: Any) -> None:
        if query_dim > sequence_dim:
            raise ValueError("query_dim > sequence_dim not supported")
        super().__init__(sequence_dim, query_dim, input, attn_mlp, generator,
                         max_seq_length)

    def output_dim(self) -> int:
        return self._sequence_dim

    def forward(self, group: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        sequence, lengths = self._inputs(group)
        scores = self._scores(group[f"{self.input}.query"], sequence,
                              compute_dtype)
        scores = torch.softmax(
            _mask_scores(scores.float(), lengths, sequence.shape[1]), dim=-1)
        return _weighted_sum(scores, sequence)


class SimpleAttention(SequenceEncoder):
    """Dot-product attention of the query over the sequence."""

    def __init__(self, sequence_dim: int, query_dim: int, input: str,
                 generator: torch.Generator, max_seq_length: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(input, max_seq_length)
        self._sequence_dim = sequence_dim

    def output_dim(self) -> int:
        return self._sequence_dim

    def forward(self, group: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        sequence, lengths = self._inputs(group)
        query = group[f"{self.input}.query"]
        scores = torch.bmm(sequence, query[:, :, None])[..., 0]
        scores = torch.softmax(
            _mask_scores(scores.float(), lengths, sequence.shape[1]), dim=-1)
        return _weighted_sum(scores, sequence)


class PoolingEncoder(SequenceEncoder):
    """Masked sum or mean over the valid positions."""

    def __init__(self, sequence_dim: int, input: str,
                 generator: torch.Generator, pooling_type: str = "mean",
                 max_seq_length: int = 0, **kwargs: Any) -> None:
        super().__init__(input, max_seq_length)
        if pooling_type not in ("sum", "mean"):
            raise ValueError(f"pooling_type {pooling_type!r}: sum or mean")
        self._sequence_dim = sequence_dim
        self._pooling_type = pooling_type

    def output_dim(self) -> int:
        return self._sequence_dim

    def forward(self, group: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        sequence, lengths = self._inputs(group)
        mask = _valid(lengths, sequence.shape[1])
        pooled = (sequence * mask[..., None]).sum(dim=1)
        if self._pooling_type == "mean":
            pooled = pooled / lengths.to(pooled.dtype).clamp(min=1.0)[:, None]
        return pooled


class SelfAttentionEncoder(SequenceEncoder):
    """Multi-head self attention over the sequence, then the masked mean
    of its output over the valid positions."""

    def __init__(self, sequence_dim: int, input: str,
                 generator: torch.Generator, multihead_attn_dim: int = 512,
                 num_heads: int = 8, dropout: float = 0.0,
                 max_seq_length: int = 0, **kwargs: Any) -> None:
        super().__init__(input, max_seq_length)
        if multihead_attn_dim % num_heads:
            raise ValueError(f"multihead_attn_dim {multihead_attn_dim} is not "
                             f"divisible by num_heads {num_heads}")
        self._generator = generator
        self._attn_dim = multihead_attn_dim
        self._num_heads = num_heads
        self._dropout = dropout
        d, a = sequence_dim, multihead_attn_dim
        self.q = linear(d, a, generator)
        self.k = linear(d, a, generator)
        self.v = linear(d, a, generator)
        self.o = linear(a, a, generator)

    def output_dim(self) -> int:
        return self._attn_dim

    def forward(self, group: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        sequence, lengths = self._inputs(group)
        b, L, _ = sequence.shape
        h = self._num_heads
        dh = self._attn_dim // h
        q, k, v = (linear_apply(lin, sequence, compute_dtype).reshape(
            b, L, h, dh) for lin in (self.q, self.k, self.v))
        # the scale rounded to the inputs' dtype first, as the JAX package
        scale = float(torch.tensor(math.sqrt(dh)).to(q.dtype))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        mask = _valid(lengths, L)
        logits = torch.where(mask[:, None, None, :], logits.float(),
                             logits.new_full((), _NEG_PAD, dtype=torch.float32))
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = dropout(attn, self._dropout, self.training, self._generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, L, -1)
        out = linear_apply(self.o, out, compute_dtype)
        return (out * mask[..., None]).sum(dim=1) / lengths.to(
            out.dtype).clamp(min=1.0)[:, None]


class MultiWindowDINEncoder(_AttentionMLP):
    """DIN scores through a sigmoid weight the valid positions; the
    output is the weighted sum over the whole sequence, then one over
    each window of ``windows_len`` consecutive positions."""

    def __init__(self, sequence_dim: int, query_dim: int, input: str,
                 attn_mlp: Dict[str, Any], generator: torch.Generator,
                 windows_len: Optional[Sequence[int]] = None,
                 **kwargs: Any) -> None:
        super().__init__(sequence_dim, query_dim, input, attn_mlp, generator)
        self.windows_len = [int(w) for w in windows_len or []]

    def output_dim(self) -> int:
        return self._sequence_dim * (len(self.windows_len) + 1)

    def forward(self, group: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        sequence = group[f"{self.input}.sequence"]
        lengths = group[f"{self.input}.sequence_length"]
        b, max_len, d = sequence.shape
        scores = self._scores(group[f"{self.input}.query"], sequence,
                              compute_dtype)
        weighted = (sequence
                    * torch.sigmoid(scores.float()).to(sequence.dtype)[..., None]
                    * _valid(lengths, max_len)[..., None])
        outs = [weighted.sum(dim=1)]
        start = 0
        for w in self.windows_len:
            end = min(start + w, max_len)
            outs.append(weighted[:, start:end].sum(dim=1) if end > start
                        else weighted.new_zeros((b, d)))
            start = end
        return torch.cat(outs, dim=-1)


_ENCODER_CLASS = {
    "din_encoder": "DINEncoder",
    "simple_attention": "SimpleAttention",
    "pooling_encoder": "PoolingEncoder",
    "self_attention_encoder": "SelfAttentionEncoder",
    "multi_window_din_encoder": "MultiWindowDINEncoder",
}


def create_seq_encoder(seq_encoder_config, group_total_dims: Dict[str, int],
                       generator: torch.Generator,
                       default_input: str = "") -> SequenceEncoder:
    """SeqEncoderConfig proto -> encoder. ``group_total_dims`` maps
    ``{group}.query`` and ``{group}.sequence`` to their widths; the query
    width defaults to the sequence's. ``default_input`` stands in for an
    empty ``input`` (a group with one nested sequence group)."""
    from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

    which = seq_encoder_config.WhichOneof("seq_module")
    kwargs = config_to_kwargs(getattr(seq_encoder_config, which))
    kwargs.pop("name", None)
    input_name = kwargs.pop("input", "") or default_input
    seq_dim = group_total_dims[f"{input_name}.sequence"]
    query_dim = group_total_dims.get(f"{input_name}.query", seq_dim)
    cls = _SEQ_ENCODER_CLASS_MAP[_ENCODER_CLASS[which]]
    return cls(sequence_dim=seq_dim, query_dim=query_dim, input=input_name,
               generator=generator, **kwargs)

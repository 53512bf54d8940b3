"""GR input preprocessors: content encoders, contextualized MLPs, the
interleave/sum preprocessor and the UIH-only preprocessor.

Counterpart of torcheasyrec_tpu/modules/gr/preprocessors.py. Every path
works on padded [B, L, D] tensors; the sequence is assembled by the one
gather of ``hstu_transducer.compact_concat``. Interleaving is a
stack and reshape. In training mode the interleave preprocessor
interleaves the targets too; in eval they stay single tokens.

The factory maps the config's oneof as the JAX package does:
  contextual_preprocessor            -> interleave class, interleaving off
  contextual_interleave_preprocessor -> interleave class, interleaving on
  uih_preprocessor                   -> UIHPreprocessor

Parameter names follow the JAX package's pytree keys (``content_encoder``,
``content_mlp``, ``ctx_proj``, ``action``, ``action_mlp``,
``target_action``; ``proj`` of the UIH preprocessor), so that
``utils/convert.from_jax_state`` carries them across. The contextual
dropout of the parameterized MLP draws from the model's
``torch.Generator``.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.modules.gr.encoders import SimpleActionEncoder
from torcheasyrec_tpu_torch.modules.gr.hstu_transducer import (
    compact_concat,
    compact_concat_2d,
)
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import (
    LayerNorm,
    dropout,
    linear,
    linear_apply,
)
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


def swish_layer_norm(x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
    """x * sigmoid(LN(x)), in fp32, cast back to x's dtype."""
    return (x.float() * torch.sigmoid(ln(x).float())).to(x.dtype)


# -- content encoders ----------------------------------------------------------


class SliceContentEncoder(nn.Module):
    """Slices the candidates' dims down to the history's."""

    def __init__(self, uih_dim: int, cand_dim: int) -> None:
        super().__init__()
        if cand_dim < uih_dim:
            raise ValueError(
                f"slice_content_encoder needs cand_dim >= uih_dim "
                f"({cand_dim} < {uih_dim})")
        self.uih_dim = uih_dim

    def output_dim(self) -> int:
        return self.uih_dim

    def forward(self, uih_emb, cand_emb, compute_dtype):
        return uih_emb, cand_emb[..., :self.uih_dim]


class PadContentEncoder(nn.Module):
    """Pads the history up to the candidates' dim with a learned vector."""

    def __init__(self, uih_dim: int, cand_dim: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        if cand_dim <= uih_dim:
            raise ValueError(
                f"pad_content_encoder needs cand_dim > uih_dim "
                f"({cand_dim} <= {uih_dim})")
        self.cand_dim = cand_dim
        self.enrich = nn.Parameter(0.1 * torch.randn(
            cand_dim - uih_dim, generator=generator,
            device=generator.device))

    def output_dim(self) -> int:
        return self.cand_dim

    def forward(self, uih_emb, cand_emb, compute_dtype):
        b, lu, _ = uih_emb.shape
        pad = self.enrich.to(uih_emb.dtype).expand(b, lu, -1)
        return torch.cat([uih_emb, pad], dim=-1), cand_emb


class MLPContentEncoder(nn.Module):
    """Separate history and candidate MLPs onto one dim."""

    def __init__(self, uih_dim: int, cand_dim: int, uih_mlp: dict,
                 target_mlp: dict, generator: torch.Generator) -> None:
        super().__init__()
        self.uih = mlp_from_config(uih_dim, uih_mlp, generator)
        self.target = mlp_from_config(cand_dim, target_mlp, generator)
        if self.uih.output_dim() != self.target.output_dim():
            raise ValueError("mlp_content_encoder: uih_mlp and target_mlp "
                             "output dims must match")

    def output_dim(self) -> int:
        return self.uih.output_dim()

    def forward(self, uih_emb, cand_emb, compute_dtype):
        return (self.uih(uih_emb, compute_dtype),
                self.target(cand_emb, compute_dtype))


def content_encoder_from_config(cfg, uih_dim: int, cand_dim: int,
                                generator: torch.Generator) -> nn.Module:
    which = cfg.WhichOneof("content_encoder")
    if which == "slice_content_encoder":
        return SliceContentEncoder(uih_dim, cand_dim)
    if which == "pad_content_encoder":
        return PadContentEncoder(uih_dim, cand_dim, generator)
    if which == "mlp_content_encoder":
        mc = cfg.mlp_content_encoder
        return MLPContentEncoder(uih_dim, cand_dim,
                                 config_to_kwargs(mc.uih_mlp),
                                 config_to_kwargs(mc.target_mlp), generator)
    raise ValueError(f"unknown content encoder: {which}")


# -- contextualized MLPs -------------------------------------------------------


class SimpleContextualizedMLP(nn.Module):
    """Linear -> SwishLayerNorm -> Linear -> LayerNorm per token; the
    contextual input is not read."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        dev = generator.device
        self.l1 = linear(in_dim, hidden_dim, generator)
        self.sln = LayerNorm(hidden_dim, dev)
        self.l2 = linear(hidden_dim, out_dim, generator)
        self.ln = LayerNorm(out_dim, dev)

    def forward(self, x, contextual_raw, compute_dtype):
        h = swish_layer_norm(linear_apply(self.l1, x, compute_dtype),
                             self.sln)
        return self.ln(linear_apply(self.l2, h, compute_dtype))


class ParameterizedContextualizedMLP(nn.Module):
    """y = x @ W(ctx) + b(ctx): per-sample weights and bias generated
    from the contextual features, which contextual dropout drops first
    in training mode. W is normalized jointly over its [in, out] entries
    (``w_norm``, a LayerNorm of that shape)."""

    def __init__(self, ctx_dim: int, in_dim: int, out_dim: int,
                 hidden_dim: int, generator: torch.Generator,
                 contextual_dropout_ratio: float = 0.3) -> None:
        super().__init__()
        dev = generator.device
        self._generator = generator
        self.in_dim, self.out_dim = in_dim, out_dim
        self.ctx_dropout = contextual_dropout_ratio
        self.compress = linear(ctx_dim, hidden_dim, generator)
        self.raw_w = linear(hidden_dim, in_dim * out_dim, generator)
        self.w_norm = LayerNorm((in_dim, out_dim), dev)
        self.res1 = linear(hidden_dim, hidden_dim, generator)
        self.res_sln = LayerNorm(hidden_dim, dev)
        self.res2 = linear(hidden_dim, out_dim, generator)

    def _weights(self, contextual_raw, compute_dtype):
        """(W [B, in, out] in the contextual input's dtype, b [B, out])."""
        c = dropout(contextual_raw, self.ctx_dropout, self.training,
                    self._generator)
        shared = linear_apply(self.compress, c, compute_dtype)
        w = linear_apply(self.raw_w, shared, compute_dtype).reshape(
            -1, self.in_dim, self.out_dim)
        w = F.layer_norm(w.float(), self.w_norm.weight.shape,
                         self.w_norm.weight, self.w_norm.bias,
                         self.w_norm.eps)
        r = swish_layer_norm(linear_apply(self.res1, shared, compute_dtype),
                             self.res_sln)
        bias = linear_apply(self.res2, r, compute_dtype)
        return w.to(contextual_raw.dtype), bias

    def forward(self, x, contextual_raw, compute_dtype):
        if contextual_raw is None:
            raise ValueError("parameterized_mlp requires contextual features")
        w, bias = self._weights(contextual_raw, compute_dtype)
        y = torch.einsum("bli,bio->blo", x.float(),
                         w.to(x.dtype).float()).to(x.dtype)
        return y + bias[:, None, :].to(x.dtype)


def contextualized_mlp_from_config(cfg, ctx_dim: int, in_dim: int,
                                   out_dim: int,
                                   generator: torch.Generator) -> nn.Module:
    which = cfg.WhichOneof("contextualized_mlp")
    if which == "simple_mlp":
        return SimpleContextualizedMLP(in_dim, out_dim,
                                       int(cfg.simple_mlp.hidden_dim),
                                       generator)
    if which == "parameterized_mlp":
        pm = cfg.parameterized_mlp
        return ParameterizedContextualizedMLP(
            ctx_dim, in_dim, out_dim, int(pm.hidden_dim), generator,
            float(pm.contextual_dropout_ratio))
    raise ValueError(f"unknown contextualized mlp: {which}")


# -- interleave helpers --------------------------------------------------------


def interleave_tokens(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, L, E] x 2 -> [B, 2L, E] as a0 b0 a1 b1 ..."""
    bsz, length, e = a.shape
    return torch.stack([a, b], dim=2).reshape(bsz, 2 * length, e)


def repeat2(x: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, 2L], each step twice."""
    return torch.repeat_interleave(x, 2, dim=1)


def _action_mlp(action_encoder, action_mlp_cfg, contextual_dim: int,
                embedding_dim: int, generator) -> Optional[nn.Module]:
    if action_encoder is None:
        return None
    if action_mlp_cfg is None or not action_mlp_cfg.WhichOneof(
            "contextualized_mlp"):
        raise ValueError("action_mlp must be set when action_encoder is set")
    return contextualized_mlp_from_config(
        action_mlp_cfg, contextual_dim, action_encoder.output_dim(),
        embedding_dim, generator)


def _ctx_tokens(proj: nn.Linear, contextual_emb, b: int, n_ctx: int, e: int,
                compute_dtype) -> torch.Tensor:
    return linear_apply(proj, contextual_emb, compute_dtype).reshape(
        b, n_ctx, e)


# -- preprocessors -------------------------------------------------------------


class ContextualInterleavePreprocessor(nn.Module):
    """Content and action paths. With ``enable_interleaving`` each history
    step becomes [content token, action token] (the targets too in
    training); without, the two paths are summed per step. The targets'
    action input is the learned ``target_action`` vector."""

    def __init__(
        self,
        embedding_dim: int,
        uih_content_dim: int,
        cand_content_dim: int,
        content_encoder: nn.Module,
        content_mlp_cfg,
        generator: torch.Generator,
        contextual_dim: int = 0,
        n_contextual_tokens: int = 0,
        action_encoder: Optional[SimpleActionEncoder] = None,
        action_mlp_cfg=None,
        enable_interleaving: bool = True,
        input_dropout_ratio: float = 0.0,
    ) -> None:
        super().__init__()
        if enable_interleaving and action_encoder is None:
            raise ValueError("enable_interleaving requires an action_encoder")
        self._generator = generator
        self.e = embedding_dim
        self.n_ctx = n_contextual_tokens if contextual_dim > 0 else 0
        self.content_encoder = content_encoder
        self.content_mlp = contextualized_mlp_from_config(
            content_mlp_cfg, contextual_dim, content_encoder.output_dim(),
            embedding_dim, generator)
        self.ctx_proj = (linear(contextual_dim, self.n_ctx * embedding_dim,
                                generator) if self.n_ctx else None)
        self.action = action_encoder
        self.action_mlp = _action_mlp(action_encoder, action_mlp_cfg,
                                      contextual_dim, embedding_dim,
                                      generator)
        self.target_action = (nn.Parameter(0.1 * torch.randn(
            action_encoder.output_dim(), generator=generator,
            device=generator.device)) if action_encoder is not None
            else None)
        self.enable_interleaving = enable_interleaving
        self.dropout = input_dropout_ratio

    def interleave_targets(self, training: bool) -> bool:
        return bool(training and self.enable_interleaving)

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
        dt = compute_dtype
        b, lu_max, _ = uih_emb.shape
        lc_max = cand_emb.shape[1]
        lu = uih_lengths.to(torch.int32)
        lc = cand_lengths.to(torch.int32)
        u_c, c_c = self.content_encoder(uih_emb, cand_emb, dt)
        content_u = self.content_mlp(u_c, contextual_emb, dt)
        content_c = self.content_mlp(c_c, contextual_emb, dt)

        action_u = action_c = None
        if self.action is not None:
            aw = (action_weights if action_weights is not None else
                  torch.zeros((b, lu_max), dtype=torch.int32,
                              device=uih_emb.device))
            a_u = self.action(aw, watchtimes)
            a_c = self.target_action.to(a_u.dtype).expand(b, lc_max, -1)
            action_u = self.action_mlp(a_u.to(content_u.dtype),
                                       contextual_emb, dt)
            action_c = self.action_mlp(a_c.to(content_c.dtype),
                                       contextual_emb, dt)

        def ts(t, twice: bool):
            if t is None:
                return None
            return repeat2(t.float()) if twice else t.float()

        if self.enable_interleaving:
            u_tok = interleave_tokens(content_u, action_u)
            out_lu = 2 * lu
            ts_u = ts(uih_timestamps, True)
            both = self.interleave_targets(self.training)
            c_tok = (interleave_tokens(content_c, action_c) if both
                     else content_c)
            num_targets = 2 * lc if both else lc
            ts_c_width = 2 * lc_max if both else lc_max
            ts_c = ts(cand_timestamps, both)
        else:
            u_tok = content_u + action_u if action_u is not None else content_u
            c_tok = content_c + action_c if action_c is not None else content_c
            out_lu, num_targets, ts_c_width = lu, lc, lc_max
            ts_u = ts(uih_timestamps, False)
            ts_c = ts(cand_timestamps, False)

        pieces = [u_tok, c_tok]
        if self.n_ctx and contextual_emb is not None:
            pieces.insert(0, _ctx_tokens(self.ctx_proj, contextual_emb, b,
                                         self.n_ctx, self.e, dt))
        x = compact_concat(torch.cat(pieces, dim=1), self.n_ctx,
                           u_tok.shape[1], out_lu)
        x = dropout(x, self.dropout, self.training, self._generator)
        lengths = self.n_ctx + out_lu + num_targets

        timestamps = None
        if ts_u is not None:
            if ts_c is None:
                ts_c = ts_u.new_zeros((b, ts_c_width))
            ts_src = torch.cat([ts_u.new_zeros((b, self.n_ctx)), ts_u, ts_c],
                               dim=1)
            timestamps = compact_concat_2d(ts_src, self.n_ctx,
                                           u_tok.shape[1], out_lu)
        return x, lengths, num_targets, timestamps


class UIHPreprocessor(nn.Module):
    """History only: projects it to the STU dim, adds the action MLP's
    embedding per step where there is an action encoder, and prepends
    the contextual tokens; no targets."""

    def __init__(
        self,
        embedding_dim: int,
        uih_content_dim: int,
        generator: torch.Generator,
        contextual_dim: int = 0,
        n_contextual_tokens: int = 0,
        action_encoder: Optional[SimpleActionEncoder] = None,
        action_mlp_cfg=None,
        input_dropout_ratio: float = 0.0,
    ) -> None:
        super().__init__()
        self._generator = generator
        self.e = embedding_dim
        self.n_ctx = n_contextual_tokens if contextual_dim > 0 else 0
        self.proj = linear(uih_content_dim, embedding_dim, generator)
        self.ctx_proj = (linear(contextual_dim, self.n_ctx * embedding_dim,
                                generator) if self.n_ctx else None)
        self.action = action_encoder
        self.action_mlp = _action_mlp(action_encoder, action_mlp_cfg,
                                      contextual_dim, embedding_dim,
                                      generator)
        self.enable_interleaving = False
        self.dropout = input_dropout_ratio

    def interleave_targets(self, training: bool) -> bool:
        return False

    def forward(
        self,
        uih_emb: torch.Tensor,
        uih_lengths: torch.Tensor,
        compute_dtype: torch.dtype,
        contextual_emb: Optional[torch.Tensor] = None,
        action_weights: Optional[torch.Tensor] = None,
        watchtimes: Optional[torch.Tensor] = None,
        uih_timestamps: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Optional[torch.Tensor]]:
        dt = compute_dtype
        b = uih_emb.shape[0]
        lu = uih_lengths.to(torch.int32)
        x = linear_apply(self.proj, uih_emb, dt)
        if self.action is not None and action_weights is not None:
            a_u = self.action(action_weights, watchtimes)
            x = x + self.action_mlp(a_u.to(x.dtype), contextual_emb, dt)
        if self.n_ctx and contextual_emb is not None:
            x = torch.cat([_ctx_tokens(self.ctx_proj, contextual_emb, b,
                                       self.n_ctx, self.e, dt), x], dim=1)
        x = dropout(x, self.dropout, self.training, self._generator)
        timestamps = None
        if uih_timestamps is not None:
            timestamps = torch.cat([
                uih_timestamps.new_zeros((b, self.n_ctx), dtype=torch.float32),
                uih_timestamps.float()], dim=1)
        return x, self.n_ctx + lu, torch.zeros_like(lu), timestamps


# -- factories -----------------------------------------------------------------


def action_encoder_from_config(cfg, generator: torch.Generator
                               ) -> Optional[SimpleActionEncoder]:
    """A GRActionEncoder config -> its encoder, None where unset."""
    if cfg is None or not cfg.WhichOneof("action_encoder"):
        return None
    ac = cfg.simple_action_encoder
    return SimpleActionEncoder(
        action_embedding_dim=int(ac.action_embedding_dim or 8),
        action_weights=list(ac.action_weights) or [1],
        generator=generator,
        watchtime_to_action_thresholds=list(ac.watchtime_to_action_thresholds),
        embedding_init_std=float(ac.embedding_init_std or 0.1),
    )


def preprocessor_from_config(
    pre_cfg,  # GRInputPreprocessor
    embedding_dim: int,
    uih_content_dim: int,
    cand_content_dim: int,
    generator: torch.Generator,
    contextual_dim: int = 0,
    n_contextual_tokens: int = 0,
    input_dropout_ratio: float = 0.0,
) -> Optional[nn.Module]:
    """The configured preprocessor; None when no oneof is set."""
    which = pre_cfg.WhichOneof("input_preprocessor") if pre_cfg else None
    if which is None:
        return None
    pcfg = getattr(pre_cfg, which)
    action_encoder = action_encoder_from_config(
        pcfg.action_encoder if pcfg.HasField("action_encoder") else None,
        generator)
    action_mlp_cfg = pcfg.action_mlp if pcfg.HasField("action_mlp") else None
    if which == "uih_preprocessor":
        return UIHPreprocessor(
            embedding_dim, uih_content_dim, generator,
            contextual_dim=contextual_dim,
            n_contextual_tokens=n_contextual_tokens,
            action_encoder=action_encoder, action_mlp_cfg=action_mlp_cfg,
            input_dropout_ratio=input_dropout_ratio)
    enable_interleaving = which == "contextual_interleave_preprocessor" and (
        not pcfg.HasField("enable_interleaving")
        or bool(pcfg.enable_interleaving))
    return ContextualInterleavePreprocessor(
        embedding_dim, uih_content_dim, cand_content_dim,
        content_encoder_from_config(pcfg.content_encoder, uih_content_dim,
                                    cand_content_dim, generator),
        pcfg.content_mlp, generator,
        contextual_dim=contextual_dim,
        n_contextual_tokens=n_contextual_tokens,
        action_encoder=action_encoder, action_mlp_cfg=action_mlp_cfg,
        enable_interleaving=enable_interleaving,
        input_dropout_ratio=input_dropout_ratio)

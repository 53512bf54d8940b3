"""DLRM-HSTU generative ranking model, inference.

Counterpart of torcheasyrec_tpu/models/dlrm_hstu.py (``__init__`` and
``predict``): uih + candidate sequences -> HSTUTransducer -> per-candidate
item MLP -> fusion multi-task heads. Feature-group contract as in the JAX
package: ``contextual`` (DEEP, optional), ``uih`` and ``candidate``
(sequence groups), and optional ``uih_action`` / ``uih_watchtime`` /
``uih_timestamp`` / ``candidate_timestamp`` sequence groups carrying one
scalar per step. ``model_config.kernel`` picks the attention: PALLAS (the
default), CUTLASS or TRITON run the CUDA kernel on the card, PYTORCH or
JAX the plain version. Losses and metrics arrive with training.
"""

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules.gr.encoders import (
    OutputPostprocessor,
    PositionalEncoder,
    SimpleActionEncoder,
)
from torcheasyrec_tpu_torch.modules.gr.hstu_transducer import (
    ContextualPreprocessor,
    HSTUTransducer,
    extract_candidates,
)
from torcheasyrec_tpu_torch.modules.gr.stu import stu_from_config
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.ops import normalize_kernel
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

_AUX_GROUPS = ("uih_action", "uih_watchtime", "uih_timestamp",
               "candidate_timestamp")


class DlrmHSTU(BaseModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        self._build_embedding_group()
        mc = self._model_config
        hstu_cfg = mc.hstu
        stu_cfg = config_to_kwargs(hstu_cfg.stu)
        e = int(stu_cfg["embedding_dim"])
        if hstu_cfg.attn_truncation_split_layer > 0:
            raise NotImplementedError("attention truncation is not ported")

        eg = self.embedding_group
        dims = eg.seq_group_dims()
        uih_dim = dims["uih.sequence"]
        cand_dim = dims["candidate.sequence"]
        self._has_ctx = eg.has_group("contextual")
        ctx_dim = eg.group_total_dim("contextual") if self._has_ctx else 0
        n_ctx_features = (
            len(eg.group_dims("contextual")) if self._has_ctx else 0
        )
        self._aux_groups = {name: eg.has_group(name) for name in _AUX_GROUPS}

        pre_cfg = hstu_cfg.input_preprocessor
        which_pre = pre_cfg.WhichOneof("input_preprocessor")
        action_encoder = None
        if which_pre is not None:
            pcfg = getattr(pre_cfg, which_pre)
            if which_pre != "contextual_preprocessor" or pcfg.content_mlp.WhichOneof(
                "contextualized_mlp"
            ):
                raise NotImplementedError(
                    f"input preprocessor {which_pre} is ported only as a "
                    "contextual_preprocessor without a content MLP"
                )
            if pcfg.HasField("action_encoder") and (
                pcfg.action_encoder.WhichOneof("action_encoder")
            ):
                ac = pcfg.action_encoder.simple_action_encoder
                action_encoder = SimpleActionEncoder(
                    action_embedding_dim=int(ac.action_embedding_dim or 8),
                    action_weights=list(ac.action_weights) or [1],
                    generator=g,
                    watchtime_to_action_thresholds=list(
                        ac.watchtime_to_action_thresholds
                    ),
                    embedding_init_std=float(ac.embedding_init_std or 0.1),
                )
        pre = ContextualPreprocessor(
            embedding_dim=e,
            uih_content_dim=uih_dim,
            cand_content_dim=cand_dim,
            generator=g,
            contextual_dim=ctx_dim,
            # one token per contextual feature
            n_contextual_tokens=n_ctx_features,
            action_encoder=action_encoder,
            input_dropout_ratio=float(hstu_cfg.input_dropout_ratio),
        )
        if not hstu_cfg.stu.HasField("num_layers"):
            stu_cfg["num_layers"] = int(hstu_cfg.attn_num_layers)
        stack = stu_from_config(stu_cfg, g,
                                kernel=normalize_kernel(
                                    self._base_model_config.kernel))
        # the contextual prefix length feeds the attention mask
        stack.set_contextual_seq_len(pre.n_ctx)

        pos = None
        if hstu_cfg.HasField("positional_encoder"):
            pc = hstu_cfg.positional_encoder
            pos = PositionalEncoder(
                embedding_dim=e,
                num_position_buckets=int(pc.num_position_buckets or 8192),
                generator=g,
                num_time_buckets=int(pc.num_time_buckets or 0),
                use_time_encoding=bool(pc.use_time_encoding),
            )
        post = None
        if hstu_cfg.HasField("output_postprocessor"):
            which = hstu_cfg.output_postprocessor.WhichOneof(
                "output_postprocessor"
            )
            kind = {
                "l2norm_postprocessor": "l2_norm",
                "layernorm_postprocessor": "layer_norm",
                "timestamp_layernorm_postprocessor": "timestamp_layer_norm",
            }[which]
            post = OutputPostprocessor(kind, e, g)
        self.transducer = HSTUTransducer(
            pre, stack, pos, post, max_seq_len=int(mc.max_seq_len),
        )

        ft = mc.fusion_mtl_tower
        self._task_cfgs = list(ft.task_configs)
        item_hidden = int(mc.item_embedding_hidden_dim or 512)
        self.item_proj = linear(cand_dim, item_hidden, g)
        tower_in = e + item_hidden
        self.tower_mlp = (
            mlp_from_config(tower_in, config_to_kwargs(ft.mlp), g)
            if ft.HasField("mlp") else None
        )
        tower_out = self.tower_mlp.output_dim() if self.tower_mlp else tower_in
        self.task_heads = nn.ModuleDict({
            t.task_name: linear(tower_out, int(t.num_class), g)
            for t in self._task_cfgs
        })

    def _seq_scalar(self, grouped, group: str):
        """[B, L] scalar values of an aux sequence group, or None."""
        if not self._aux_groups.get(group):
            return None
        return grouped[f"{group}.sequence"][..., 0]

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        cand = grouped["candidate.sequence"]
        cand_len = grouped["candidate.sequence_length"]
        seq_out, lengths, num_targets = self.transducer(
            dt,
            uih_emb=grouped["uih.sequence"],
            uih_lengths=grouped["uih.sequence_length"],
            cand_emb=cand,
            cand_lengths=cand_len,
            contextual_emb=grouped.get("contextual") if self._has_ctx else None,
            action_weights=self._seq_scalar(grouped, "uih_action"),
            watchtimes=self._seq_scalar(grouped, "uih_watchtime"),
            uih_timestamps=self._seq_scalar(grouped, "uih_timestamp"),
            cand_timestamps=self._seq_scalar(grouped, "candidate_timestamp"),
        )
        lc_max = cand.shape[1]
        # targets sit at [lengths - num_targets, lengths)
        cand_out = extract_candidates(seq_out, 0, lengths - num_targets,
                                      lc_max)
        item_h = F.silu(linear_apply(self.item_proj, cand, dt))
        h = torch.cat([cand_out, item_h], dim=-1)
        if self.tower_mlp is not None:
            h = self.tower_mlp(h, dt)
        preds: Dict[str, torch.Tensor] = {"__candidate_lengths": cand_len}
        for t in self._task_cfgs:
            logits = linear_apply(self.task_heads[t.task_name], h, dt).float()
            logits = logits[..., 0]  # [B, Lc]
            preds[f"logits_{t.task_name}"] = logits
            preds[f"probs_{t.task_name}"] = torch.sigmoid(logits)
        return preds

"""DLRM-HSTU generative ranking model.

Counterpart of torcheasyrec_tpu/models/dlrm_hstu.py: uih + candidate
sequences -> HSTUTransducer -> per-candidate item MLP -> fusion
multi-task heads. Feature-group contract as in the JAX package:
``contextual`` (DEEP, optional), ``uih`` and ``candidate`` (sequence
groups), and optional ``uih_action`` / ``uih_watchtime`` /
``uih_timestamp`` / ``candidate_timestamp`` sequence groups carrying one
scalar per step. ``model_config.kernel`` picks the attention: PALLAS (the
default), CUTLASS or TRITON run the CUDA kernel on the card, PYTORCH or
JAX the plain version. A ``contextual_preprocessor`` or
``contextual_interleave_preprocessor`` with a content MLP builds the
content/action-MLP family (``modules/gr/preprocessors.py``), any other
preprocessor the linear ``ContextualPreprocessor``; under target
interleaving each candidate's content token carries its prediction.
``attn_truncation_split_layer`` and ``attn_truncation_tail_len`` cut the
history between two layer ranges. The loss is a per-task BCE over the
real candidates; labels come from a per-candidate sequence column,
optionally through ``task_bitmask``. The eval metrics are one per task
and metric config, ``<metric>_<task>``, over the real candidates.
``hstu`` may be a repeated field (ULTRA-HSTU): its first entry builds
the base channel.
"""

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.losses import binary_cross_entropy
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules.gr.encoders import encoders_from_config
from torcheasyrec_tpu_torch.modules.gr.hstu_transducer import (
    ContextualPreprocessor,
    HSTUTransducer,
    extract_candidates,
)
from torcheasyrec_tpu_torch.modules.gr.preprocessors import (
    action_encoder_from_config,
    preprocessor_from_config,
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
        if hasattr(hstu_cfg, "__len__"):  # repeated field (UltraHSTU)
            hstu_cfg = hstu_cfg[0]
        stu_cfg = config_to_kwargs(hstu_cfg.stu)
        e = int(stu_cfg["embedding_dim"])
        self._e = e

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
        input_dropout = float(hstu_cfg.input_dropout_ratio)
        pre = None
        if which_pre in ("contextual_preprocessor",
                         "contextual_interleave_preprocessor") and getattr(
                pre_cfg, which_pre).content_mlp.WhichOneof(
                "contextualized_mlp"):
            pre = preprocessor_from_config(
                pre_cfg, e, uih_dim, cand_dim, g, contextual_dim=ctx_dim,
                # one token per contextual feature
                n_contextual_tokens=n_ctx_features,
                input_dropout_ratio=input_dropout)
        if pre is None:
            pcfg = getattr(pre_cfg, which_pre) if which_pre else None
            pre = ContextualPreprocessor(
                embedding_dim=e,
                uih_content_dim=uih_dim,
                cand_content_dim=cand_dim,
                generator=g,
                contextual_dim=ctx_dim,
                n_contextual_tokens=n_ctx_features,
                action_encoder=action_encoder_from_config(
                    pcfg.action_encoder if pcfg is not None
                    and pcfg.HasField("action_encoder") else None, g),
                input_dropout_ratio=input_dropout,
            )
        if not hstu_cfg.stu.HasField("num_layers"):
            stu_cfg["num_layers"] = int(hstu_cfg.attn_num_layers)
        stack = stu_from_config(stu_cfg, g,
                                kernel=normalize_kernel(
                                    self._base_model_config.kernel))
        # the contextual prefix length feeds the attention mask
        stack.set_contextual_seq_len(pre.n_ctx)

        pos, post = encoders_from_config(hstu_cfg, e, g)
        self.transducer = HSTUTransducer(
            pre, stack, pos, post, max_seq_len=int(mc.max_seq_len),
            attn_truncation_split_layer=int(
                hstu_cfg.attn_truncation_split_layer),
            attn_truncation_tail_len=int(hstu_cfg.attn_truncation_tail_len),
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
        # targets sit at [lengths - num_targets, lengths) of the returned
        # layout; interleaved, each candidate's content token is first
        stride = 2 if self.transducer.pre.interleave_targets(
            self.training) else 1
        cand_out = extract_candidates(seq_out, 0, lengths - num_targets,
                                      lc_max, stride)
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

    def _task_labels(self, t, batch: Batch, lc_max: int) -> torch.Tensor:
        """Per-candidate labels [B, Lc] from a sequence feature column."""
        name = t.label_name
        if name in batch.sequence_dense_features:
            vals = batch.sequence_dense_features[name].values[..., 0]
        elif name in batch.sequence_sparse_features:
            vals = batch.sequence_sparse_features[name].values
        elif name in batch.labels:
            vals = batch.labels[name]
            if vals.dim() == 1:
                vals = vals[:, None]
        else:
            raise KeyError(f"label {name} not found in batch")
        # align to the candidates' padded length
        cur = vals.shape[1]
        if cur < lc_max:
            vals = F.pad(vals, (0, lc_max - cur))
        elif cur > lc_max:
            vals = vals[:, :lc_max]
        if t.task_bitmask:
            vals = (vals.to(torch.int32) & int(t.task_bitmask)) > 0
        return vals.float()

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        """``bce_<task>``: task weight x mean BCE over the real
        candidates of the batch."""
        cand_len = predictions["__candidate_lengths"]
        losses = {}
        for t in self._task_cfgs:
            logits = predictions[f"logits_{t.task_name}"]
            lc_max = logits.shape[1]
            labels = self._task_labels(t, batch, lc_max)
            mask = (
                torch.arange(lc_max, device=logits.device)[None, :]
                < cand_len.to(torch.int32)[:, None]
            ).float()
            per = binary_cross_entropy(logits, labels) * mask
            denom = mask.sum().clamp(min=1.0)
            losses[f"bce_{t.task_name}"] = (
                float(t.weight or 1.0) * per.sum() / denom)
        return losses

    def init_metrics(self) -> List[Dict[str, Any]]:
        """One metric per task and metric config, named
        ``<metric>_<task>``."""
        from torcheasyrec_tpu_torch.metrics import create_metric

        out = []
        for t in self._task_cfgs:
            for c in t.metrics:
                m = create_metric(c)
                m["name"] = f"{m['name']}_{t.task_name}"
                m["task"] = t
                out.append(m)
        return out

    def update_metrics(self, metrics: List[Dict[str, Any]],
                       predictions: Dict[str, torch.Tensor],
                       batch: Batch) -> None:
        """Each task's probabilities and labels over the real candidates."""
        cand_len = predictions["__candidate_lengths"].cpu().numpy()
        for m in metrics:
            t = m["task"]
            probs = predictions[f"probs_{t.task_name}"].float().cpu().numpy()
            lc_max = probs.shape[1]
            labels = self._task_labels(t, batch, lc_max).cpu().numpy()
            mask = np.arange(lc_max)[None, :] < cand_len[:, None]
            m["metric"].update(probs[mask], labels[mask])

"""HSTU-Match retrieval.

Counterpart of torcheasyrec_tpu/models/hstu_match.py. The user tower runs
the user interaction history through a UIH preprocessor (an optional
action encoder and contextual prefix tokens), a positional encoder whose
time deltas are anchored at the request time (``query_time``) where the
config has that group, and the STU stack; the last valid token's output
is the user embedding. The item tower is a ``MatchTower`` over the
candidates' embeddings.

Two candidate modes:

- **scalar** (a DEEP item group): one positive a row, scored by
  ``MatchModel._sim`` against in-batch or sampled negatives.
- **jagged** (a sequence item group): K_i positives a row. The sampler's
  negatives arrive as extra single-item rows of the candidate columns,
  after the B rows of positives. Each positive is scored against
  [itself | the shared negatives | its user's hard negatives], giving a
  similarity of [B * Lc, 1 + M (+ hard columns)] with a mask over the
  real positives; the loss is the masked mean of the softmax cross
  entropy, and the metrics read the real positives' rows. In-batch
  negatives are refused in this mode.
"""

from typing import Dict, List, Optional

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.losses import softmax_cross_entropy
from torcheasyrec_tpu_torch.parallel.mesh import batch_mean
from torcheasyrec_tpu_torch.models.match_model import (
    HARD_SLOT_FILL,
    MatchModel,
    l2_normalize,
)
from torcheasyrec_tpu_torch.modules.gr.encoders import encoders_from_config
from torcheasyrec_tpu_torch.modules.gr.hstu_transducer import HSTUTransducer
from torcheasyrec_tpu_torch.modules.gr.preprocessors import (
    UIHPreprocessor,
    action_encoder_from_config,
    preprocessor_from_config,
)
from torcheasyrec_tpu_torch.modules.gr.stu import stu_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.ops import normalize_kernel
from torcheasyrec_tpu_torch.protos import simi_pb2
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class HSTUMatch(MatchModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        self._build_embedding_group()
        mc = self._model_config
        ut = mc.user_tower
        eg = self.embedding_group
        self._seq_group = ut.input
        self._item_group = mc.item_tower.input
        dims = eg.seq_group_dims()
        seq_dim = dims[f"{self._seq_group}.sequence"]
        hstu_cfg = ut.hstu
        stu_cfg = config_to_kwargs(hstu_cfg.stu)
        e = int(stu_cfg["embedding_dim"])

        self._jagged_items = f"{self._item_group}.sequence" in dims
        if self._jagged_items and self._in_batch_negative:
            raise ValueError(
                "HSTUMatch with a jagged candidate group does not support "
                "in_batch_negative; use a negative sampler.")

        self._ctx_key = None
        if eg.has_group("contextual"):
            self._ctx_key = "contextual"
        elif "contextual.query" in dims:
            self._ctx_key = "contextual.query"
        ctx_dim = eg.group_total_dim(self._ctx_key) if self._ctx_key else 0
        n_ctx = len(eg.group_dims(self._ctx_key)) if self._ctx_key else 0
        self._aux_groups = {
            name: f"{name}.sequence" in dims
            for name in ("uih_action", "uih_watchtime", "uih_timestamp")
        }
        self._has_qt = eg.has_group("query_time")

        pre_cfg = (hstu_cfg.input_preprocessor
                   if hstu_cfg.HasField("input_preprocessor") else None)
        which_pre = (pre_cfg.WhichOneof("input_preprocessor")
                     if pre_cfg is not None else None)
        input_dropout = float(hstu_cfg.input_dropout_ratio)
        if which_pre == "uih_preprocessor":
            pre = preprocessor_from_config(
                pre_cfg, e, seq_dim, 0, g, contextual_dim=ctx_dim,
                n_contextual_tokens=n_ctx, input_dropout_ratio=input_dropout)
        else:
            # another preprocessor's action encoder and MLP, if any, on
            # the UIH-only layout
            pcfg = getattr(pre_cfg, which_pre) if which_pre else None
            pre = UIHPreprocessor(
                e, seq_dim, g, contextual_dim=ctx_dim,
                n_contextual_tokens=n_ctx,
                action_encoder=action_encoder_from_config(
                    pcfg.action_encoder if pcfg is not None
                    and pcfg.HasField("action_encoder") else None, g),
                action_mlp_cfg=(pcfg.action_mlp if pcfg is not None
                                and pcfg.HasField("action_mlp") else None),
                input_dropout_ratio=input_dropout)
        stack = stu_from_config(
            stu_cfg, g, kernel=normalize_kernel(
                self._base_model_config.kernel))
        pos, post = encoders_from_config(hstu_cfg, e, g)
        self.transducer = HSTUTransducer(
            pre, stack, pos, post, max_seq_len=int(ut.max_seq_len),
            attn_truncation_split_layer=int(
                hstu_cfg.attn_truncation_split_layer),
            attn_truncation_tail_len=int(hstu_cfg.attn_truncation_tail_len),
        )
        item_in = (dims[f"{self._item_group}.sequence"] if self._jagged_items
                   else eg.group_total_dim(self._item_group))
        self.item_tower = self._match_tower(mc.item_tower, item_in)
        self.user_out = (linear(e, self._output_dim, g)
                         if self._output_dim > 0 else None)

    def tower_specs(self) -> Dict[str, Dict]:
        """The user tower reads the history and every auxiliary group
        it uses at forward time."""
        user_groups = [self._seq_group]
        if self._ctx_key:
            user_groups.append(self._ctx_key.split(".")[0])
        user_groups += [g for g, ok in self._aux_groups.items() if ok]
        if self._has_qt:
            user_groups.append("query_time")
        return {
            "user": {"groups": user_groups, "output": "user_tower_emb"},
            "item": {"groups": [self._item_group],
                     "output": "item_tower_emb"},
        }

    # -- towers ----------------------------------------------------------------

    def _seq_scalar(self, grouped, group: str) -> Optional[torch.Tensor]:
        """[B, L] scalar values of an aux sequence group, or None."""
        if not self._aux_groups.get(group):
            return None
        return grouped[f"{group}.sequence"][..., 0]

    def _encode_user(self, grouped: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        inputs = dict(
            uih_emb=grouped[f"{self._seq_group}.sequence"],
            uih_lengths=grouped[f"{self._seq_group}.sequence_length"],
            contextual_emb=grouped[self._ctx_key] if self._ctx_key else None,
            action_weights=self._seq_scalar(grouped, "uih_action"),
            watchtimes=self._seq_scalar(grouped, "uih_watchtime"),
            uih_timestamps=self._seq_scalar(grouped, "uih_timestamp"),
        )
        if self._has_qt:
            qt = grouped["query_time"]
            inputs["time_anchor"] = qt[..., 0] if qt.dim() > 1 else qt
        seq_out, out_lengths, _ = self.transducer(self.compute_dtype,
                                                  **inputs)
        last = (out_lengths.long() - 1).clamp(min=0)
        user_emb = torch.gather(
            seq_out, 1, last[:, None, None].expand(-1, 1, seq_out.shape[2])
        )[:, 0]
        if self.user_out is not None:
            user_emb = linear_apply(self.user_out, user_emb,
                                    self.compute_dtype)
        if self._similarity == simi_pb2.COSINE:
            user_emb = l2_normalize(user_emb)
        return user_emb

    def unsharded_reduction(self):
        return "HSTU-Match's similarity over the batch's item blocks"

    def predict_tower(self, grouped: Dict[str, torch.Tensor], batch: Batch,
                      tower: str) -> torch.Tensor:
        if tower == "item":
            if self._jagged_items:
                # a serving row is a one-item candidate sequence
                return self.item_tower(
                    grouped[f"{self._item_group}.sequence"],
                    self.compute_dtype)[:, 0]
            return self.item_tower(grouped[self._item_group],
                                   self.compute_dtype)
        if tower == "user":
            return self._encode_user(grouped)
        raise ValueError(f"unknown tower {tower!r}")

    # -- forward ---------------------------------------------------------------

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        user_emb = self._encode_user(grouped)
        hard_neg_indices = batch.additional.get("hard_neg_indices")
        if not self._jagged_items:
            return self._two_tower_predict(
                user_emb, self.predict_tower(grouped, batch, "item"), batch)

        # [B rows of K_i positives | M shared negatives | hard slots]
        cand = grouped[f"{self._item_group}.sequence"]
        cand_len = grouped[f"{self._item_group}.sequence_length"]
        item_tok = self.item_tower(cand, self.compute_dtype)  # [R, Lc, D]
        b, lc = user_emb.shape[0], item_tok.shape[1]
        neg_rows = item_tok[b:, 0].float()  # [M + hard, D]
        n_hard = 0 if hard_neg_indices is None else hard_neg_indices.shape[0]
        uf = user_emb.float()
        blocks = [torch.einsum("bd,bcd->bc", uf,
                               item_tok[:b].float())[..., None]]
        n_simple = neg_rows.shape[0] - n_hard
        if n_simple > 0:
            blocks.append((uf @ neg_rows[:n_simple].T)[:, None, :].expand(
                b, lc, n_simple))
        if n_hard:
            # each hard negative against its own user, in its user's row
            # and column; the empty slots' row B is cut off after the
            # scatter
            rows = hard_neg_indices[:, 0].long().clamp(max=b)
            cols = hard_neg_indices[:, 1].long()
            hard_sim = (uf[rows.clamp(max=b - 1)] * neg_rows[n_simple:]).sum(
                -1)
            n_cols = max(n_hard // b, 1)
            hard_mat = torch.full((b + 1, n_cols), HARD_SLOT_FILL,
                                  dtype=torch.float32, device=uf.device)
            hard_mat = hard_mat.index_put((rows, cols), hard_sim)[:b]
            blocks.append(hard_mat[:, None, :].expand(b, lc, n_cols))
        sim = torch.cat(blocks, dim=-1)  # [B, Lc, 1 + M + hard columns]
        mask = (torch.arange(lc, device=uf.device)[None, :]
                < cand_len[:b].long()[:, None])
        return {
            "similarity": sim.reshape(b * lc, -1),
            "similarity_mask": mask.reshape(-1),
            "user_tower_emb": user_emb,
            "item_tower_emb": item_tok[:, 0],
        }

    # -- loss and metrics (jagged mode masks the padded positives) -------------

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        if not self._jagged_items:
            return super().loss(predictions, batch)
        sim = predictions["similarity"] / self._temperature
        mask = predictions["similarity_mask"].float()
        per = softmax_cross_entropy(
            sim, torch.zeros(sim.shape[0], dtype=torch.long,
                             device=sim.device))
        if self._sample_weight_name:
            w = batch.sample_weights[self._sample_weight_name].float()
            mask = mask * torch.repeat_interleave(w, sim.shape[0]
                                                  // w.shape[0])
        return {"softmax_cross_entropy": batch_mean(
            (per * mask).sum(), mask.sum(), self.shard, eps=1.0)}

    def update_metrics(self, metrics: List[Dict], predictions: Dict,
                       batch: Batch) -> None:
        if not self._jagged_items:
            return super().update_metrics(metrics, predictions, batch)
        sim = predictions["similarity"].float().cpu().numpy()
        mask = predictions["similarity_mask"].cpu().numpy().astype(bool)
        for m in metrics:
            m["metric"].update(sim[mask], None)

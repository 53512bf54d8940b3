"""MIND: multi-interest retrieval.

Counterpart of torcheasyrec_tpu/models/mind.py. The user side: the
history group (optionally through ``hist_seq_mlp``) routed into K
interest capsules (``modules/capsule.py``), the user group through
``user_mlp``, the two combined per interest (CONCAT, or SUM where
``user_mlp``'s width equals the capsules'; else CONCAT, as in the JAX
package), then ``concat_mlp`` and the output linear ``user_out``, and
the COSINE normalization where configured: [B, K, output_dim]. The item
side is a ``MatchTower``. A user scores an item by label-aware
attention: a softmax over the user's active interests of ``simi_pow``
times their scores weights those scores. Over several ranks a rank's
users score every rank's item rows, gathered with their gradients in the
layout of ``MatchModel._sim``'s in-batch negatives ([every rank's
positives | every rank's sampled negatives]), as the JAX package's one
program scores the global batch's.
"""

from typing import Dict, Tuple

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.match_model import MatchModel, l2_normalize
from torcheasyrec_tpu_torch.modules.capsule import _MASKED, CapsuleLayer
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.parallel.mesh import all_gather_with_grad
from torcheasyrec_tpu_torch.protos import simi_pb2
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

_CONCAT, _SUM = 0, 1  # MINDUserTower.UserSeqCombineMethod


class MIND(MatchModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._build_embedding_group()
        g = self._generator
        mc = self._model_config
        ut = mc.user_tower
        eg = self.embedding_group
        self._user_group = ut.input
        self._hist_group = ut.history_input
        self._item_group = mc.item_tower.input
        hist_dim = eg.seq_group_dims()[f"{self._hist_group}.sequence"]
        self.user_mlp = mlp_from_config(
            eg.group_total_dim(self._user_group),
            config_to_kwargs(ut.user_mlp), g)
        self.hist_mlp = (
            mlp_from_config(hist_dim, config_to_kwargs(ut.hist_seq_mlp), g)
            if ut.HasField("hist_seq_mlp") else None)
        seq_dim = self.hist_mlp.output_dim() if self.hist_mlp else hist_dim
        cc = config_to_kwargs(ut.capsule_config)
        self.capsule = CapsuleLayer(
            input_dim=seq_dim,
            generator=g,
            max_k=int(cc.get("max_k", 5)),
            max_seq_len=int(cc["max_seq_len"]),
            high_dim=int(cc["high_dim"]),
            num_iters=int(cc.get("num_iters", 3)),
            routing_logits_scale=float(cc.get("routing_logits_scale", 20)),
            routing_logits_stddev=float(cc.get("routing_logits_stddev", 1)),
            squash_pow=float(cc.get("squash_pow", 1)),
            const_caps_num=bool(cc.get("const_caps_num", False)),
        )
        self._combine = ut.user_seq_combine
        if (self._combine == _SUM
                and self.user_mlp.output_dim() != self.capsule.high_dim):
            self._combine = _CONCAT
        concat_in = self.capsule.high_dim + (
            self.user_mlp.output_dim() if self._combine == _CONCAT else 0)
        self.concat_mlp = mlp_from_config(
            concat_in, config_to_kwargs(ut.concat_mlp), g)
        self.item_tower = self._match_tower(
            mc.item_tower, eg.group_total_dim(self._item_group))
        self.user_out = linear(self.concat_mlp.output_dim(),
                               self._output_dim, g)
        self._simi_pow = float(mc.simi_pow)

    def _interests(self, grouped: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(interest embeddings [B, K, output_dim], interest mask [B, K])."""
        dt = self.compute_dtype
        seq = grouped[f"{self._hist_group}.sequence"]
        lengths = grouped[f"{self._hist_group}.sequence_length"]
        if self.hist_mlp is not None:
            seq = self.hist_mlp(seq, dt)
        interests, cap_mask = self.capsule(seq, lengths, dt)
        user = self.user_mlp(grouped[self._user_group], dt)
        user_k = user[:, None, :].expand(-1, interests.shape[1], -1)
        if self._combine == _SUM:
            h = interests + user_k
        else:
            h = torch.cat([interests, user_k], dim=-1)
        out = linear_apply(self.user_out, self.concat_mlp(h, dt), dt)
        if self._similarity == simi_pb2.COSINE:
            out = l2_normalize(out)
        return out, cap_mask

    def tower_specs(self) -> Dict[str, Dict]:
        return {
            "user": {"groups": [self._user_group, self._hist_group],
                     "output": "user_interests"},
            "item": {"groups": [self._item_group],
                     "output": "item_tower_emb"},
        }

    def predict_tower(self, grouped: Dict[str, torch.Tensor], batch: Batch,
                      tower: str) -> torch.Tensor:
        """The user's [B, K, D] interests (serving retrieves per interest
        and takes the union), or the item embeddings."""
        if tower == "user":
            return self._interests(grouped)[0]
        if tower == "item":
            return self.item_tower(grouped[self._item_group],
                                   self.compute_dtype)
        raise ValueError(f"unknown tower {tower!r}")

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        interests, cap_mask = self._interests(grouped)
        item_emb = self.predict_tower(grouped, batch, "item")
        b = interests.shape[0]
        pos_rows, neg_rows = item_emb[:b].float(), item_emb[b:].float()
        off = 0
        if self.shard is not None:
            # every rank's item rows, as the JAX package's one program
            # sees them: [every rank's positives | every rank's negatives]
            pos_rows = all_gather_with_grad(pos_rows, self.shard)
            neg_rows = all_gather_with_grad(neg_rows, self.shard)
            off = self.in_batch_offset(b)
        n_pos = pos_rows.shape[0]
        items = torch.cat([pos_rows, neg_rows])
        scores = interests.float() @ items.T  # [B, K, B + S] (global)
        masked = torch.where(cap_mask[:, :, None], scores,
                             scores.new_full((), _MASKED))
        attn = torch.softmax(self._simi_pow * masked, dim=1)
        sim_all = (attn * masked).sum(1)  # [B, B + S]
        # the positive is the user's own item (the diagonal, from the
        # rank's first global row)
        pos = sim_all.diagonal(off)[:, None]
        if sim_all.shape[1] > n_pos:
            sim = torch.cat([pos, sim_all[:, n_pos:]], dim=1)
        else:
            sim = sim_all if self._in_batch_negative else pos
        preds = self._sim_to_prediction(sim)
        if self._in_batch_negative and self.shard is not None:
            preds["__in_batch_offset"] = torch.tensor(off)
        preds["user_interests"] = interests
        preds["item_tower_emb"] = item_emb
        return preds

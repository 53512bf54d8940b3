"""DAT: the dual augmented two-tower model.

Counterpart of torcheasyrec_tpu/models/dat.py. Each tower reads its
feature group and an augment group (``augment_input``), concatenated.
The adaptive-mimic losses pull each side's augment vector, cut or
zero-padded to ``output_dim``, towards the other tower's embedding of the
positive pair: ``amm_loss_u`` (user augment against the item embedding)
and ``amm_loss_i`` (item augment, its first B rows, against the user
embedding), each with the target detached. The augment vectors are the
hidden outputs ``__augment_a_user`` and ``__augment_a_item``, which
predict does not write.
"""

from typing import Dict

import torch
import torch.nn.functional as F

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.match_model import MatchModel


def _to_width(x: torch.Tensor, d: int) -> torch.Tensor:
    """x's first d columns, zero-padded where it has fewer."""
    return F.pad(x[..., :d], (0, max(d - x.shape[-1], 0)))


class DAT(MatchModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._build_embedding_group()
        mc = self._model_config
        eg = self.embedding_group
        ut, it = mc.user_tower, mc.item_tower
        self.user_tower = self._match_tower(
            ut, eg.group_total_dim(ut.input)
            + eg.group_total_dim(ut.augment_input))
        self.item_tower = self._match_tower(
            it, eg.group_total_dim(it.input)
            + eg.group_total_dim(it.augment_input))
        self._groups = (ut.input, ut.augment_input, it.input,
                        it.augment_input)
        self._amm_i = float(mc.amm_i_weight)
        self._amm_u = float(mc.amm_u_weight)

    def tower_specs(self) -> Dict[str, Dict]:
        ug, uag, ig, iag = self._groups
        return {
            "user": {"groups": [ug, uag], "output": "user_tower_emb"},
            "item": {"groups": [ig, iag], "output": "item_tower_emb"},
        }

    def predict_tower(self, grouped: Dict[str, torch.Tensor], batch: Batch,
                      tower: str) -> torch.Tensor:
        ug, uag, ig, iag = self._groups
        if tower == "user":
            return self.user_tower(
                torch.cat([grouped[ug], grouped[uag]], dim=-1),
                self.compute_dtype)
        if tower == "item":
            return self.item_tower(
                torch.cat([grouped[ig], grouped[iag]], dim=-1),
                self.compute_dtype)
        raise ValueError(f"unknown tower {tower!r}")

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        preds = self._two_tower_predict(
            self.predict_tower(grouped, batch, "user"),
            self.predict_tower(grouped, batch, "item"), batch)
        preds["__augment_a_user"] = grouped[self._groups[1]]
        preds["__augment_a_item"] = grouped[self._groups[3]]
        return preds

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        losses = super().loss(predictions, batch)
        ue = predictions["user_tower_emb"].float()
        ie = predictions["item_tower_emb"].float()
        b, d = ue.shape
        au = _to_width(predictions["__augment_a_user"].float(), d)
        ai = _to_width(predictions["__augment_a_item"].float()[:b], d)
        losses["amm_loss_u"] = self._amm_u * self.batch_mean(
            (au - ie[:b].detach()).square().sum(-1))
        losses["amm_loss_i"] = self._amm_i * self.batch_mean(
            (ai - ue.detach()).square().sum(-1))
        return losses

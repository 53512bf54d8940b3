"""MatchModel and MatchTower: the base of the two-tower retrieval models.

Counterpart of torcheasyrec_tpu/models/match_model.py, for one process.
The user tower gives [B, D] and the item tower [B + S (+ H), D]: the
batch's positive items, then the S negatives the sampler shared across
the batch, then H = B * num_hard_sample hard-negative slots. ``_sim``
scores them as [B, 1 + S (+ H / B)] with the positive in column 0, or as
[B, B + S] with the positives on the diagonal for in-batch negatives; the
loss is softmax cross entropy of ``similarity / temperature``. The
similarity is computed from fp32 operands (exact products of bf16
values) and stays fp32, as the JAX package's fp32-accumulated dot
products are. The JAX package's per-process block layout of ``_sim``
(several hosts, each with its own sampler) is not ported.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.losses import softmax_cross_entropy
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.parallel.mesh import all_gather_with_grad
from torcheasyrec_tpu_torch.protos import simi_pb2
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

# the score a hard-negative slot without an item gets
HARD_SLOT_FILL = -1e9


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / |x| along the last axis, the norm from fp32 with 1e-12 under
    the root, cast back to x's dtype (COSINE similarity)."""
    return x * torch.rsqrt(
        x.float().square().sum(-1, keepdim=True) + 1e-12).to(x.dtype)


class MatchTower(nn.Module):
    """A feature group's MLP (where configured), then the output linear to
    ``output_dim`` (where > 0), then the normalization of COSINE."""

    def __init__(self, tower_config, output_dim: int, similarity: int,
                 in_dim: int, generator: torch.Generator) -> None:
        super().__init__()
        self.mlp = (
            mlp_from_config(in_dim, config_to_kwargs(tower_config.mlp),
                            generator)
            if tower_config.HasField("mlp") else None)
        hidden = self.mlp.output_dim() if self.mlp is not None else in_dim
        self.output = (linear(hidden, output_dim, generator)
                       if output_dim > 0 else None)
        self.similarity = similarity

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        if self.mlp is not None:
            x = self.mlp(x, compute_dtype)
        if self.output is not None:
            x = linear_apply(self.output, x, compute_dtype)
        if self.similarity == simi_pb2.COSINE:
            x = l2_normalize(x)
        return x


class MatchModel(BaseModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        mc = self._model_config
        self._similarity = getattr(mc, "similarity", simi_pb2.INNER_PRODUCT)
        self._temperature = float(getattr(mc, "temperature", 1.0) or 1.0)
        self._in_batch_negative = bool(getattr(mc, "in_batch_negative",
                                               False))
        self._output_dim = int(getattr(mc, "output_dim", 0) or 0)
        self._sample_weight_name = (
            self._sample_weights[0] if self._sample_weights else None)

    def _match_tower(self, tower_config, in_dim: int) -> MatchTower:
        return MatchTower(tower_config, self._output_dim, self._similarity,
                          in_dim, self._generator)

    # -- one tower at a time (a later export serves each on its own) --------

    def tower_specs(self) -> Dict[str, Dict]:
        """tower name -> {groups, output}: the feature groups the tower
        reads and the prediction key of its embedding."""
        mc = self._model_config
        return {
            "user": {"groups": [mc.user_tower.input],
                     "output": "user_tower_emb"},
            "item": {"groups": [mc.item_tower.input],
                     "output": "item_tower_emb"},
        }

    def predict_tower(self, grouped: Dict[str, torch.Tensor], batch: Batch,
                      tower: str) -> torch.Tensor:
        """One tower's embedding from the grouped features."""
        mc = self._model_config
        if tower == "user":
            return self.user_tower(grouped[mc.user_tower.input],
                                   self.compute_dtype)
        if tower == "item":
            return self.item_tower(grouped[mc.item_tower.input],
                                   self.compute_dtype)
        raise ValueError(f"unknown tower {tower!r}")

    # -- similarity and loss -------------------------------------------------

    def _sim(self, user_emb: torch.Tensor, item_emb: torch.Tensor,
             hard_neg_indices: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """[B, 1 + S (+ H / B)], column 0 the positive; [B, B + S] for
        in-batch negatives.

        With ``hard_neg_indices`` [H, 2] (user row, hard column), the last
        H item rows are hard negatives, each scored against its own user
        only and placed in column 1 + S + hard column; a slot whose user
        row is B holds no item and keeps ``HARD_SLOT_FILL``.

        Over several ranks each rank holds its own block of the JAX
        package's global item rows ([its B positives | its S negatives |
        its hard negatives]), so sampled and hard negatives score against
        the rank's own negatives, the JAX package's block p. In-batch
        negatives score against every rank's items, gathered with their
        gradients and laid out as the JAX package reorders them: [every
        rank's positives | every rank's sampled negatives]; the positive
        of local row i is then column ``in_batch_offset() + i``."""
        b = user_emb.shape[0]
        u, items = user_emb.float(), item_emb.float()
        if self._in_batch_negative:
            shard = getattr(self, "shard", None)
            if shard is not None:
                items = torch.cat([all_gather_with_grad(items[:b], shard),
                                   all_gather_with_grad(items[b:], shard)])
            return u @ items.T
        n_hard = 0 if hard_neg_indices is None else hard_neg_indices.shape[0]
        s = items.shape[0] - b - n_hard
        out = (u * items[:b]).sum(-1, keepdim=True)
        if s > 0:
            out = torch.cat([out, u @ items[b:b + s].T], dim=1)
        if n_hard:
            rows = hard_neg_indices[:, 0].long().clamp(max=b)
            cols = hard_neg_indices[:, 1].long()
            hard_sim = (u[rows.clamp(max=b - 1)] * items[b + s:]).sum(-1)
            # the empty slots' user row B is a scratch row, cut off after
            # the scatter: they never reach a user's row
            hard_mat = torch.full((b + 1, max(n_hard // b, 1)),
                                  HARD_SLOT_FILL, dtype=torch.float32,
                                  device=u.device)
            hard_mat = hard_mat.index_put((rows, cols), hard_sim)[:b]
            out = torch.cat([out, hard_mat], dim=1)
        return out

    def _sim_to_prediction(self, sim: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        return {"similarity": sim.float()}

    def in_batch_offset(self, b: int) -> int:
        """The global row of this rank's first user: the users of the
        ranks before it (0 on one rank)."""
        if self.shard is None:
            return 0
        counts = self.shard.all_gather_list(torch.tensor([b]))
        return int(sum(int(c) for c in counts[:self.shard.rank]))

    def _two_tower_predict(self, user_emb, item_emb, batch: Batch
                           ) -> Dict[str, torch.Tensor]:
        preds = self._sim_to_prediction(self._sim(
            user_emb, item_emb, batch.additional.get("hard_neg_indices")))
        if self._in_batch_negative and self.shard is not None:
            # the column of row 0's positive, for the loss and the metrics
            preds["__in_batch_offset"] = torch.tensor(
                self.in_batch_offset(user_emb.shape[0]))
        preds["user_tower_emb"] = user_emb
        preds["item_tower_emb"] = item_emb
        return preds

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        """Softmax cross entropy of ``similarity / temperature``: the
        positive is column 0, or the diagonal for in-batch negatives. The
        users (rows) are the batch; the item rows may be more."""
        sim = predictions["similarity"] / self._temperature
        b = sim.shape[0]
        if self._in_batch_negative:
            labels = torch.arange(b, device=sim.device) + int(
                predictions.get("__in_batch_offset", 0))
        else:
            labels = torch.zeros(b, dtype=torch.long, device=sim.device)
        return {"softmax_cross_entropy": self._reduce(
            softmax_cross_entropy(sim, labels), batch,
            self._sample_weight_name)}

    def update_metrics(self, metrics: List[Dict], predictions: Dict,
                       batch: Batch) -> None:
        """The metrics read ``similarity``; in-batch rows are rotated so
        the positive is column 0."""
        sim = predictions["similarity"].float().cpu().numpy()
        if self._in_batch_negative:
            b, n = sim.shape
            off = int(predictions.get("__in_batch_offset", 0))
            idx = (np.arange(n)[None, :] + np.arange(b)[:, None] + off) % n
            sim = np.take_along_axis(sim, idx, axis=1)
        for m in metrics:
            m["metric"].update(sim, None)

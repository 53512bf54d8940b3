"""RankModel: base of the single-label ranking models.

Counterpart of torcheasyrec_tpu/models/rank_model.py
(``_output_to_prediction`` and ``loss``). Builds the EmbeddingGroup with
the model's ``wide_embedding_dim``; the output head gives ``logits`` and
``probs`` (sigmoid for one class, softmax otherwise); the loss is each
configured loss reduced over the batch with the sample weights.
``jrc_loss`` reads its session ids through ``_grouping_value_dev`` and
needs a head of two classes or more.
"""

from typing import Any, Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.losses import create_loss_fn
from torcheasyrec_tpu_torch.models.model import BaseModel


class RankModel(BaseModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._label_name = self._labels[0] if self._labels else None
        self._sample_weight_name = (
            self._sample_weights[0] if self._sample_weights else None)
        self._loss_fns = [create_loss_fn(c) for c in self._loss_cfgs]
        if self._num_class < 2 and any(lf["name"] == "jrc_loss"
                                       for lf in self._loss_fns):
            # the JAX package reads logits[:, 1] of a one-wide head as
            # column 0, clamped, and the listwise term then trains nothing
            raise ValueError(
                f"loss jrc_loss needs num_class >= 2, config has "
                f"{self._num_class}")
        self._build_embedding_group(
            wide_embedding_dim=getattr(
                self._model_config, "wide_embedding_dim", None),
            wide_init_fn=getattr(self._model_config, "wide_init_fn", None),
        )

    def _output_to_prediction(self, output: torch.Tensor,
                              suffix: str = "") -> Dict[str, torch.Tensor]:
        """Output head: logits [B] (num_class == 1) or [B, C], in fp32."""
        preds = {}
        output = output.float()
        use_softmax_ce = any(lf["name"] in SOFTMAX_LOSSES
                             for lf in self._loss_fns)
        if self._num_class == 1 and not use_softmax_ce:
            logits = output[..., 0] if output.dim() > 1 else output
            preds[f"logits{suffix}"] = logits
            preds[f"probs{suffix}"] = torch.sigmoid(logits)
        elif self._num_class <= 2 and use_softmax_ce:
            preds[f"logits{suffix}"] = output
            preds[f"probs{suffix}"] = torch.softmax(output, dim=-1)[..., 1]
        else:
            preds[f"logits{suffix}"] = output
            preds[f"probs{suffix}"] = torch.softmax(output, dim=-1)
            preds[f"y{suffix}"] = output[..., 0]
        return preds

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        losses = {}
        label = batch.labels[self._label_name]
        for lf in self._loss_fns:
            name = lf["name"]
            inp = predictions["logits"]
            if name == "l2_loss":
                inp = predictions.get("y", predictions["probs"])
            losses[name] = self._reduce(
                lf["fn"](inp, label, **loss_kwargs(lf, batch, self.shard)),
                batch,
                self._sample_weight_name)
        return losses


# losses over class logits: the head keeps [B, C] logits and its probs are
# the softmax's (class 1's for two classes)
SOFTMAX_LOSSES = ("softmax_cross_entropy", "jrc_loss")


def loss_kwargs(lf: Dict[str, Any], batch: Batch,
                shard=None) -> Dict[str, Any]:
    """The keyword arguments of a loss beside logits and labels: JRC's
    session ids and the ranks its listwise term spans."""
    if lf["name"] == "jrc_loss":
        return {"session_ids": _grouping_value_dev(batch, lf["session_name"]),
                "shard": shard}
    return {}


def _grouping_value_dev(batch: Batch, key: str) -> torch.Tensor:
    """A grouping column on the device: a label, the first id of a sparse
    feature (-1 where a jagged row has none) or the first value of a
    dense one."""
    if key in batch.labels:
        return batch.labels[key]
    if key in batch.sparse_features:
        f = batch.sparse_features[key]
        if f.is_fixed:
            return f.values[:, 0]
        lengths = f.lengths.long()
        starts = (torch.cumsum(lengths, 0) - lengths).clamp(
            max=f.values.shape[0] - 1)
        return torch.where(lengths > 0, f.values[starts],
                           f.values.new_full((), -1))
    if key in batch.dense_features:
        return batch.dense_features[key].values[:, 0]
    raise KeyError(f"grouping key {key} not in batch")

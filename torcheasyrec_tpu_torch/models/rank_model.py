"""RankModel: base of the single-label ranking models.

Counterpart of torcheasyrec_tpu/models/rank_model.py
(``_output_to_prediction`` and ``loss``). Builds the EmbeddingGroup with
the model's ``wide_embedding_dim``; the output head gives ``logits`` and
``probs`` (sigmoid for one class, softmax otherwise); the loss is each
configured loss reduced over the batch with the sample weights.
``jrc_loss`` raises NotImplementedError.
"""

from typing import Dict

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
        use_softmax_ce = any(lf["name"] == "softmax_cross_entropy"
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
            losses[name] = self._reduce(lf["fn"](inp, label), batch,
                                        self._sample_weight_name)
        return losses

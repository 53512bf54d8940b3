"""RocketLaunching: a booster net and a light net trained together.

Counterpart of torcheasyrec_tpu/models/rocket_launching.py. The first
group goes through the optional shared MLP (``share``), then through
the booster MLP (``booster``, ``booster_out``) and the light MLP
(``light``, ``light_out``). Outputs ``*_booster`` and ``*_light``;
``logits`` and ``probs`` are the light net's, the one served, so the
base's ``update_metrics`` reads ``probs_light``, and the metric ``auc``
is named ``auc_light``. Losses: the labelled loss of each net, the
light logits' squared distance to the booster's with the booster's
gradient stopped, and with ``feature_based_distillation`` one minus the
cosine of the two nets' last hidden layers (the first min(d) lanes,
fp32). ``feature_distillation_function`` is read as the cosine, as in
the JAX package.
"""

from typing import Any, Dict, List

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.losses import (
    binary_cross_entropy,
    softmax_cross_entropy,
)
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class RocketLaunching(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        mc = self._model_config
        self._group = self.embedding_group.group_names()[0]
        d = self.embedding_group.group_total_dim(self._group)
        self.share = None
        if mc.HasField("share_mlp"):
            self.share = mlp_from_config(d, config_to_kwargs(mc.share_mlp), g)
            d = self.share.output_dim()
        self.booster = mlp_from_config(d, config_to_kwargs(mc.booster_mlp), g)
        self.light = mlp_from_config(d, config_to_kwargs(mc.light_mlp), g)
        self.booster_out = linear(self.booster.output_dim(), self._num_class,
                                  g)
        self.light_out = linear(self.light.output_dim(), self._num_class, g)
        self.feature_based = bool(mc.feature_based_distillation)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = grouped[self._group]
        if self.share is not None:
            x = self.share(x, dt)
        hb, hl = self.booster(x, dt), self.light(x, dt)
        preds = {}
        for net, out, h in (("booster", self.booster_out, hb),
                            ("light", self.light_out, hl)):
            for k, v in self._output_to_prediction(
                    linear_apply(out, h, dt)).items():
                preds[f"{k}_{net}"] = v
        preds["logits"] = preds["logits_light"]
        preds["probs"] = preds["probs_light"]
        preds["__hidden_booster"] = hb
        preds["__hidden_light"] = hl
        return preds

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        label = batch.labels[self._label_name]

        def ce(logits):
            if logits.dim() == 2 and logits.shape[-1] > 1:
                return softmax_cross_entropy(logits, label)
            if logits.dim() == 2:
                logits = logits[:, 0]
            return binary_cross_entropy(logits, label)

        losses = {
            f"bce_{net}": self._reduce(ce(predictions[f"logits_{net}"]),
                                       batch, self._sample_weight_name)
            for net in ("booster", "light")}
        teacher = predictions["logits_booster"].detach()
        losses["distill"] = (predictions["logits_light"]
                             - teacher).square().mean()
        if self.feature_based:
            hb = predictions["__hidden_booster"].detach()
            hl = predictions["__hidden_light"]
            d = min(hb.shape[-1], hl.shape[-1])
            a, b = hl[..., :d].float(), hb[..., :d].float()
            cos = (a * b).sum(-1) * torch.rsqrt(
                (a * a).sum(-1) * (b * b).sum(-1) + 1e-12)
            losses["feature_distill"] = (1.0 - cos).mean()
        return losses

    def init_metrics(self) -> List[Dict[str, Any]]:
        out = super().init_metrics()
        for m in out:
            if m["name"] == "auc":
                m["name"] = "auc_light"
        return out

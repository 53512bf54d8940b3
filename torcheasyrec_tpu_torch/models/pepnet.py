"""PEPNet: EPNet gates the shared embedding by the domain group, then one
PPNet tower per task, each layer gated by the ``ppnet`` group's priors.

Counterpart of torcheasyrec_tpu/models/pepnet.py. Groups ``all``,
optionally ``domain`` (EPNet) and ``ppnet`` (the priors). Parameters as
the JAX tree: ``epnet``, ``ppnets.<i>`` and ``outputs.<i>`` (JAX lists).
"""

from typing import Dict

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.multi_task_rank import MultiTaskRank
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.modules.personalized_net import EPNet, PPNet


class PEPNet(MultiTaskRank):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        mc = self._model_config
        self._domain_group = "domain" if eg.has_group("domain") else None
        self._prior_group = "ppnet" if eg.has_group("ppnet") else None
        in_dim = eg.group_total_dim("all")
        self.epnet = None
        if self._domain_group:
            self.epnet = EPNet(
                in_dim, eg.group_total_dim(self._domain_group),
                int(mc.epnet_hidden_unit or in_dim), g,
                float(mc.epnet_gamma))
        prior_dim = (eg.group_total_dim(self._prior_group)
                     if self._prior_group else 0)
        self.ppnets = nn.ModuleList(
            PPNet(in_dim, prior_dim,
                  list(mc.ppnet_hidden_units) or [128, 64], g,
                  activation=mc.ppnet_activation,
                  dropout_ratio=list(mc.ppnet_dropout_ratio),
                  gamma=float(mc.ppnet_gamma))
            for _ in self._task_tower_cfgs)
        self.outputs = nn.ModuleList(
            linear(pp.output_dim(), int(t.num_class), g)
            for t, pp in zip(self._task_tower_cfgs, self.ppnets))

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = grouped["all"]
        if self.epnet is not None:
            x = self.epnet(x, grouped[self._domain_group], dt)
        prior = (grouped[self._prior_group] if self._prior_group
                 else x.new_zeros((x.shape[0], 0)))
        preds = {}
        for t, pp, out in zip(self._task_tower_cfgs, self.ppnets,
                              self.outputs):
            y = linear_apply(out, pp(x, prior, dt), dt)
            preds.update(self._task_output_to_prediction(t, y))
        return preds

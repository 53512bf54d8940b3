"""MultiTaskRank: base of the multi-task ranking models, and
SimpleMultiTask.

Counterpart of torcheasyrec_tpu/models/multi_task_rank.py. Each task
tower has its label (``label_name``, else the label fields by order),
losses, metrics, weight and sample weight. Per tower ``<t>``: outputs
``logits_<t>`` and ``probs_<t>``, losses ``<loss>_<t>`` (times the
task's weight), metrics ``<metric>_<t>`` on ``probs_<t>``. A tower's
``task_space_indicator_label`` (a label, else a feature's first value
through ``_grouping_value_dev``) weighs its samples by
``in_task_space_weight`` where it is positive and
``out_task_space_weight`` elsewhere; ``use_pareto_loss_weight`` scales
the losses by their Pareto weights (``losses/pe_mtl_loss.py``) where
there are two or more, with each tower's ``pareto_min_loss_weight`` as
its losses' floor.
"""

from typing import Any, Dict, List

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.losses import create_loss_fn
from torcheasyrec_tpu_torch.losses.pe_mtl_loss import apply_pareto_weights
from torcheasyrec_tpu_torch.metrics import TrainMetricWrapper, create_metric
from torcheasyrec_tpu_torch.models.model import _grouping_value
from torcheasyrec_tpu_torch.models.rank_model import (
    SOFTMAX_LOSSES,
    RankModel,
    _grouping_value_dev,
    loss_kwargs,
)
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class MultiTaskRank(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._task_tower_cfgs = list(self._model_config.task_towers)
        self._use_pareto = bool(model_config.use_pareto_loss_weight)
        self._pareto_floors = {
            f"{c.WhichOneof('loss')}_{t.tower_name}":
                float(t.pareto_min_loss_weight)
            for t in self._task_tower_cfgs for c in t.losses
            if c.WhichOneof("loss")}
        self._task_loss_fns: Dict[str, List[Dict[str, Any]]] = {}
        for t in self._task_tower_cfgs:
            fns = [create_loss_fn(c) for c in t.losses]
            for lf in fns:
                if lf["num_class"] > max(int(t.num_class or 1), 1):
                    raise ValueError(
                        f"task tower '{t.tower_name}': loss {lf['name']} "
                        f"needs num_class >= {lf['num_class']}, config has "
                        f"{t.num_class}")
            self._task_loss_fns[t.tower_name] = fns

    def _task_label(self, t, idx: int) -> str:
        return t.label_name if t.label_name else self._labels[idx]

    def _task_output_to_prediction(self, t, output: torch.Tensor
                                   ) -> Dict[str, torch.Tensor]:
        suffix = f"_{t.tower_name}"
        num_class = int(t.num_class or 1)
        output = output.float()
        use_softmax = any(lf["name"] in SOFTMAX_LOSSES
                          for lf in self._task_loss_fns[t.tower_name])
        if num_class == 1 and not use_softmax:
            logits = output[..., 0] if output.dim() > 1 else output
            return {f"logits{suffix}": logits,
                    f"probs{suffix}": torch.sigmoid(logits)}
        probs = torch.softmax(output, dim=-1)
        return {f"logits{suffix}": output,
                f"probs{suffix}": probs[..., 1] if num_class <= 2 else probs}

    def _task_towers(self, in_dim: int) -> None:
        """``towers`` (each tower's MLP from ``in_dim``, None where it has
        none) and ``outputs`` (one linear per tower to its classes)."""
        g = self._generator
        self.towers = nn.ModuleList(
            mlp_from_config(in_dim, config_to_kwargs(t.mlp), g)
            if t.HasField("mlp") else None for t in self._task_tower_cfgs)
        self.outputs = nn.ModuleList(
            linear(mlp.output_dim() if mlp is not None else in_dim,
                   int(t.num_class), g)
            for t, mlp in zip(self._task_tower_cfgs, self.towers))

    def _towers_predict(self, task_inputs) -> Dict[str, torch.Tensor]:
        """Each task's input through its tower and output linear."""
        dt = self.compute_dtype
        preds = {}
        for t, h, mlp, out in zip(self._task_tower_cfgs, task_inputs,
                                  self.towers, self.outputs):
            if mlp is not None:
                h = mlp(h, dt)
            preds.update(self._task_output_to_prediction(
                t, linear_apply(out, h, dt)))
        return preds

    def unsharded_reduction(self):
        if any(lf["name"] == "jrc_loss" for fns in
               self._task_loss_fns.values() for lf in fns):
            return "jrc_loss's [B, B] session matrix"
        return None

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        losses = {}
        for i, t in enumerate(self._task_tower_cfgs):
            label = batch.labels[self._task_label(t, i)]
            task_w = float(t.weight)
            logits = predictions[f"logits_{t.tower_name}"]
            extra_w = None
            if t.task_space_indicator_label:
                ind = (_grouping_value_dev(
                    batch, t.task_space_indicator_label) > 0).float()
                extra_w = (float(t.in_task_space_weight) * ind
                           + float(t.out_task_space_weight) * (1.0 - ind))
            for lf in self._task_loss_fns[t.tower_name]:
                losses[f"{lf['name']}_{t.tower_name}"] = task_w * self._reduce(
                    lf["fn"](logits, label, **loss_kwargs(lf, batch)), batch,
                    getattr(t, "sample_weight_name", "") or None, extra_w)
        if self._use_pareto and len(losses) > 1:
            # the weights come from the global losses: over several ranks
            # the mean of the ranks' values (each rank's loss is scaled
            # so that the mean is the global one)
            losses = apply_pareto_weights(
                losses, self._pareto_floors,
                reduce=None if self.shard is None else
                (lambda x: self.shard.all_reduce(x) / self.shard.world))
        return losses

    def init_metrics(self) -> List[Dict[str, Any]]:
        return self._tower_metrics("metrics")

    def init_train_metrics(self) -> List[Dict[str, Any]]:
        return self._tower_metrics("train_metrics")

    def _tower_metrics(self, field: str) -> List[Dict[str, Any]]:
        """Each tower's ``metrics`` or ``train_metrics`` (these in a
        ``TrainMetricWrapper``), named ``<metric>_<tower>``."""
        out = []
        for i, t in enumerate(self._task_tower_cfgs):
            for c in getattr(t, field):
                m = create_metric(c)
                if field == "train_metrics":
                    m["metric"] = TrainMetricWrapper(
                        m["metric"], decay_rate=c.decay_rate,
                        decay_step=c.decay_step)
                m["name"] = f"{m['name']}_{t.tower_name}"
                m["tower"] = t.tower_name
                m["label"] = self._task_label(t, i)
                out.append(m)
        return out

    def update_metrics(self, metrics: List[Dict[str, Any]],
                       predictions: Dict[str, torch.Tensor],
                       batch: Batch) -> None:
        for m in metrics:
            kw = {}
            gk = m["config"].get("grouping_key")
            if gk:
                kw["grouping_key"] = _grouping_value(batch, gk)
            preds = predictions[f"probs_{m['tower']}"].float().cpu().numpy()
            m["metric"].update(preds, batch.labels[m["label"]].cpu().numpy(),
                               **kw)


class SimpleMultiTask(MultiTaskRank):
    """The main group into one MLP tower per task."""

    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._task_towers(
            self.embedding_group.group_total_dim(self._main_group()))

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        x = grouped[self._main_group()]
        return self._towers_predict([x] * len(self._task_tower_cfgs))

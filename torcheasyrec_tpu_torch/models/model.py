"""BaseModel: model registry, the forward used for eval and predict, and
the loss surface of the train step.

Counterpart of torcheasyrec_tpu/models/model.py. A model is an
``nn.Module`` that builds its EmbeddingGroup and dense submodules in
``__init__`` and implements ``predict(grouped, batch)`` and
``loss(predictions, batch)``. Its parameters are the dense ones only;
the embedding tables live in the EmbeddingGroup's engine and are updated
by the sparse optimizer. Eval metrics accumulate on the host
(``init_metrics`` / ``update_metrics`` / ``compute_metrics``; a grouped
metric reads its grouping column through ``_grouping_value``), and so do
the train metrics (``init_train_metrics``: each config's metric in a
``TrainMetricWrapper``, fed from the train step's detached predictions).
With ``variational_dropout`` in the config, every non-sequence group of
more than one feature (its encoders' outputs counted as features) gets a
``VariationalDropout`` under ``variational_dropout.<group>``;
``build_input`` gates the groups between the embedding group and
``predict`` and gives the ``<group>_feature_p_loss`` terms the train
step adds to the losses. Its noise comes from the model's generator, or
from ``vd_noise`` ({group: u}) where that is set.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.features.feature import BaseFeature
from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
from torcheasyrec_tpu_torch.modules.variational_dropout import (
    VariationalDropout,
)
from torcheasyrec_tpu_torch.parallel.mesh import ShardContext, batch_mean
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.utils.load_class import get_register_class_meta

_MODEL_CLASS_MAP: Dict[str, type] = {}
_meta = get_register_class_meta(_MODEL_CLASS_MAP)


class BaseModel(nn.Module, metaclass=_meta):
    def __init__(
        self,
        model_config: Any,  # ModelConfig proto
        features: List[BaseFeature],
        labels: List[str],
        sample_weights: Optional[List[str]] = None,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        sparse_optimizer: Optional[SparseOptimizer] = None,
        packed: bool = True,
        dense_lane_rows: int = 32768,
        shard: Optional[ShardContext] = None,
        plan: Optional[Dict[str, str]] = None,
        build_tables: bool = True,
    ) -> None:
        super().__init__()
        self._base_model_config = model_config
        self._features = features
        self._labels = list(labels)
        self._sample_weights = list(sample_weights or [])
        self._num_class = int(model_config.num_class or 1)
        self._loss_cfgs = list(model_config.losses)
        self._metric_cfgs = list(model_config.metrics)
        self._train_metric_cfgs = list(model_config.train_metrics)
        self._engine_options = {"packed": packed,
                                "dense_lane_rows": dense_lane_rows,
                                "shard": shard, "plan": plan,
                                "build_tables": build_tables}
        # the ranks of the job: the losses' and the batch norms' batch
        # statistics and the in-batch negatives span all of them
        self.shard = shard if shard is not None and shard.world > 1 else None
        self.compute_dtype = compute_dtype
        self._generator = generator or torch.Generator()
        self._sparse_optimizer = sparse_optimizer
        which = model_config.WhichOneof("model")
        self._model_config = getattr(model_config, which) if which else None
        self.embedding_group: Optional[EmbeddingGroup] = None
        self.variational_dropout: Optional[nn.ModuleDict] = None
        self.vd_feature_names: Dict[str, List[str]] = {}
        self.vd_noise: Optional[Dict[str, torch.Tensor]] = None

    def _build_embedding_group(self, wide_embedding_dim=None,
                               wide_init_fn=None) -> None:
        self.embedding_group = EmbeddingGroup(
            self._features, list(self._base_model_config.feature_groups),
            self._generator, sparse_optimizer=self._sparse_optimizer,
            wide_embedding_dim=wide_embedding_dim, wide_init_fn=wide_init_fn,
            **self._engine_options,
        )
        self._build_variational_dropout()

    def _build_variational_dropout(self) -> None:
        """One VariationalDropout per non-sequence group of more than one
        feature, the group's encoders counted as features
        (``<group>__encoder_<i>``), as the JAX ``BaseModel`` builds them."""
        bc = self._base_model_config
        if not bc.HasField("variational_dropout"):
            return
        cfg = bc.variational_dropout
        eg = self.embedding_group
        vds = {}
        for g in eg.group_names():
            names = [key.split(":")[1] if kind == "emb" else key
                     for kind, key, _ in eg._group_slots[g]]
            names += [f"{g}__encoder_{i}"
                      for i in range(len(eg._encoders(g)))]
            dims = eg.group_dims(g)
            if len(dims) <= 1:
                continue
            vds[g] = VariationalDropout(
                dims, regularization_lambda=cfg.regularization_lambda,
                embedding_wise=cfg.embedding_wise_variational_dropout,
                device=self._generator.device)
            self.vd_feature_names[g] = names
        self.variational_dropout = nn.ModuleDict(vds)

    def build_input(self, grouped: Dict[str, torch.Tensor], batch: Batch
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """(the groups gated by their variational dropout, the
        ``<group>_feature_p_loss`` terms); the groups as they are and no
        term without variational dropout."""
        if not self.variational_dropout:
            return grouped, {}
        out, aux = dict(grouped), {}
        noise = self.vd_noise or {}
        for g, vd in self.variational_dropout.items():
            if g not in grouped:
                continue
            out[g], aux[f"{g}_feature_p_loss"] = vd(
                grouped[g], self.training, self._generator, noise.get(g))
        return out, aux

    def _main_group(self) -> str:
        """The model's input group: "all" where the config has one, else
        the first non-sequence group, as in the JAX package."""
        names = self.embedding_group.group_names()
        return "all" if "all" in names or not names else names[0]

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def loss(self, predictions: Dict[str, torch.Tensor],
             batch: Batch) -> Dict[str, torch.Tensor]:
        """{loss name: scalar} from ``predict``'s output."""
        raise NotImplementedError

    def total_loss(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        return sum(losses.values())

    def _reduce(self, per_sample: torch.Tensor, batch: Batch,
                sample_weight_name: Optional[str] = None,
                extra_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Weighted mean of per-sample losses; ``extra_weight`` (the task
        space's) multiplies the sample weight. Over several ranks the
        divisor is the global batch's (its row count, or its weight sum:
        ``mesh.batch_mean``), as the JAX package's one program over the
        global batch has it."""
        if per_sample.dim() == 0:
            return per_sample
        w = batch.sample_weights.get(sample_weight_name or "")
        if extra_weight is not None:
            w = extra_weight if w is None else w * extra_weight
        if w is None:
            if self.shard is None:
                return per_sample.mean()
            return self.batch_mean(per_sample)
        w = w.float()
        return batch_mean((per_sample * w).sum(), w.sum(), self.shard,
                          eps=1e-12)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the global batch (its first axis over
        every rank); ``x.mean()`` on one rank."""
        if self.shard is None:
            return x.mean()
        return batch_mean(x.sum(), torch.tensor(float(x.numel())),
                          self.shard)

    def attach_shard(self) -> None:
        """Give the batch norms the ranks (their batch statistics span
        them); the model's own reductions read ``self.shard``."""
        from torcheasyrec_tpu_torch.modules.module import BatchNorm

        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.shard = self.shard

    # -- metrics (host side) -------------------------------------------------

    def init_metrics(self) -> List[Dict[str, Any]]:
        from torcheasyrec_tpu_torch.metrics import create_metric

        return [create_metric(c) for c in self._metric_cfgs]

    def init_train_metrics(self) -> List[Dict[str, Any]]:
        from torcheasyrec_tpu_torch.metrics import (
            TrainMetricWrapper,
            create_metric,
        )

        out = []
        for c in self._train_metric_cfgs:
            m = create_metric(c)
            m["metric"] = TrainMetricWrapper(
                m["metric"], decay_rate=c.decay_rate, decay_step=c.decay_step)
            out.append(m)
        return out

    def update_metrics(self, metrics: List[Dict[str, Any]],
                       predictions: Dict[str, torch.Tensor],
                       batch: Batch) -> None:
        """Feed one batch's predictions and labels to the accumulators; a
        ``recall@`` metric reads ``similarity`` where there is one."""
        if not metrics:
            return
        label = batch.labels[self._labels[0]].cpu().numpy()
        probs = predictions.get("probs", predictions.get("y"))
        probs = None if probs is None else probs.float().cpu().numpy()
        for m in metrics:
            kw = {}
            gk = m["config"].get("grouping_key")
            if gk:
                kw["grouping_key"] = _grouping_value(batch, gk)
            preds = probs
            if m["name"].startswith("recall@") and "similarity" in predictions:
                preds = predictions["similarity"].float().cpu().numpy()
            m["metric"].update(preds, label, **kw)

    def compute_metrics(self, metrics: List[Dict[str, Any]]
                        ) -> Dict[str, float]:
        return {m["name"]: m["metric"].compute() for m in metrics}

    def forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Full forward for eval/predict."""
        grouped = self.embedding_group(batch, self.compute_dtype)
        grouped, _ = self.build_input(grouped, batch)
        return self.predict(grouped, batch)


def _grouping_value(batch: Batch, key: str) -> np.ndarray:
    """The grouping column of a grouped metric, on the host: a label or
    sample weight, the first id of a sparse feature (0 where a jagged
    row has none) or the first value of a dense one."""
    if key in batch.labels:
        return batch.labels[key].cpu().numpy()
    if key in batch.sample_weights:
        return batch.sample_weights[key].cpu().numpy()
    if key in batch.sparse_features:
        f = batch.sparse_features[key]
        vals = f.values.cpu().numpy()
        if f.is_fixed:
            return vals[:, 0]
        lengths = f.lengths.cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(lengths)])[:-1]
        out = np.zeros(len(lengths), vals.dtype)
        has = lengths > 0
        out[has] = vals[np.minimum(starts[has], max(len(vals) - 1, 0))]
        return out
    if key in batch.dense_features:
        return batch.dense_features[key].values[:, 0].cpu().numpy()
    raise KeyError(f"grouping key {key} not found in batch")

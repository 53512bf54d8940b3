"""Eval metrics.

Counterpart of torcheasyrec_tpu/metrics/__init__.py: exact accumulation
on the host, in numpy (predictions are tiny beside the model's work; the
eval loop copies each batch's outputs to the host once). Ported: ``auc``.
The other metrics raise NotImplementedError in ``create_metric``.
"""

from typing import Any, Dict, List

import numpy as np


def _auc(preds: np.ndarray, labels: np.ndarray) -> float:
    """Exact AUC by the rank statistic; ties take their average rank."""
    preds = np.asarray(preds, np.float64)
    labels = np.asarray(labels) > 0.5
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(preds, kind="mergesort")
    sorted_preds = preds[order]
    # runs of equal predictions share the mean of their ranks
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sorted_preds)) + 1])
    ends = np.concatenate([starts[1:], [len(preds)]])
    ranks = np.empty(len(preds), np.float64)
    ranks[order] = np.repeat((starts + 1 + ends) / 2.0, ends - starts)
    auc = (ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


class AUC:
    def __init__(self, thresholds: int = 200, **kw) -> None:
        self.reset()

    def reset(self) -> None:
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def update(self, preds, labels, **kw) -> None:
        self._preds.append(np.asarray(preds).reshape(-1))
        self._labels.append(np.asarray(labels).reshape(-1))

    def compute(self) -> float:
        return _auc(np.concatenate(self._preds), np.concatenate(self._labels))


_METRIC_CLASSES = {"auc": AUC}


def create_metric(metric_config) -> Dict[str, Any]:
    """MetricConfig proto -> {name, metric, config}."""
    from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

    which = metric_config.WhichOneof("metric")
    if which not in _METRIC_CLASSES:
        raise NotImplementedError(
            f"metric {which} is not ported; ported: {sorted(_METRIC_CLASSES)}")
    kwargs = config_to_kwargs(getattr(metric_config, which))
    return {"name": which, "metric": _METRIC_CLASSES[which](**kwargs),
            "config": kwargs}

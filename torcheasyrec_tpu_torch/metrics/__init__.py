"""Eval metrics.

Counterpart of torcheasyrec_tpu/metrics/__init__.py: exact accumulation
on the host, in numpy (predictions are tiny beside the model's work; the
eval loop copies each batch's outputs to the host once). Ported: ``auc``
and ``grouped_auc`` (named ``grouped_auc_<grouping_key>``, as the JAX
package names it) and ``recall_at_k`` (named ``recall@<top_k>``). The
other metrics raise NotImplementedError in ``create_metric``.
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


def _grouped_auc(preds: np.ndarray, labels: np.ndarray,
                 keys: np.ndarray) -> float:
    """Mean over the groups of ``keys`` of each group's exact AUC, groups
    of one class skipped; NaN when no group has both classes.

    The JAX package masks the whole column once per distinct key; this is
    one stable sort by (key, prediction) and per-group ranks, the same
    numbers: a group's rank sum is a sum of half-integers, exact in
    float64 in any order, and the per-group AUCs are averaged in the JAX
    package's order (ascending key)."""
    preds = np.asarray(preds, np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1) > 0.5
    keys = np.asarray(keys).reshape(-1)
    n = len(preds)
    order = np.lexsort((preds, keys))
    k, p, y = keys[order], preds[order], labels[order]
    new_group = np.ones(n, bool)
    new_group[1:] = k[1:] != k[:-1]
    group = np.cumsum(new_group) - 1
    group_start = np.flatnonzero(new_group)
    # runs of equal (key, prediction) share the mean of their ranks,
    # counted from 1 within the group
    new_run = new_group.copy()
    new_run[1:] |= p[1:] != p[:-1]
    starts = np.flatnonzero(new_run)
    ends = np.append(starts[1:], n)
    base = group_start[group[starts]]
    rank = np.repeat((starts - base + 1 + ends - base) / 2.0, ends - starts)
    n_groups = len(group_start)
    n_pos = np.bincount(group, weights=y, minlength=n_groups)
    n_all = np.bincount(group, minlength=n_groups).astype(np.float64)
    n_neg = n_all - n_pos
    rank_pos = np.bincount(group, weights=np.where(y, rank, 0.0),
                           minlength=n_groups)
    ok = (n_pos > 0) & (n_neg > 0)
    if not ok.any():
        return float("nan")
    aucs = ((rank_pos[ok] - n_pos[ok] * (n_pos[ok] + 1) / 2.0)
            / (n_pos[ok] * n_neg[ok]))
    return float(np.mean(aucs))


class GroupedAUC:
    def __init__(self, grouping_key: str, **kw) -> None:
        self.grouping_key = grouping_key
        self.reset()

    def reset(self) -> None:
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._keys: List[np.ndarray] = []

    def update(self, preds, labels, grouping_key=None, **kw) -> None:
        self._preds.append(np.asarray(preds).reshape(-1))
        self._labels.append(np.asarray(labels).reshape(-1))
        self._keys.append(np.asarray(grouping_key).reshape(-1))

    def compute(self) -> float:
        return _grouped_auc(np.concatenate(self._preds),
                            np.concatenate(self._labels),
                            np.concatenate(self._keys))


class RecallAtK:
    """recall@k of retrieval: a row of ``preds`` is one user's similarity
    [1 + negatives] with the positive in column 0; the row is a hit when
    fewer than ``top_k`` negatives score at least as high (a tie counts
    against the positive)."""

    def __init__(self, top_k: int = 5, **kw) -> None:
        self.top_k = top_k
        self.reset()

    def reset(self) -> None:
        self._hit = 0.0
        self._n = 0

    def update(self, preds, labels=None, **kw) -> None:
        p = np.asarray(preds)
        if p.ndim == 1:
            p = p[None, :]
        rank = (p[:, 1:] >= p[:, 0:1]).sum(axis=1)
        self._hit += float((rank < self.top_k).sum())
        self._n += p.shape[0]

    def compute(self) -> float:
        return float(self._hit / max(self._n, 1))


_METRIC_CLASSES = {"auc": AUC, "grouped_auc": GroupedAUC,
                   "recall_at_k": RecallAtK}


def create_metric(metric_config) -> Dict[str, Any]:
    """MetricConfig proto -> {name, metric, config}."""
    from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

    which = metric_config.WhichOneof("metric")
    if which not in _METRIC_CLASSES:
        raise NotImplementedError(
            f"metric {which} is not ported; ported: {sorted(_METRIC_CLASSES)}")
    cfg = getattr(metric_config, which)
    kwargs = config_to_kwargs(cfg)
    name = which
    if which == "grouped_auc":
        name = f"{which}_{cfg.grouping_key}"
    elif which == "recall_at_k":
        name = f"recall@{cfg.top_k}"
    return {"name": name, "metric": _METRIC_CLASSES[which](**kwargs),
            "config": kwargs}

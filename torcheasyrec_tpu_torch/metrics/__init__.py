"""Eval metrics.

Counterpart of torcheasyrec_tpu/metrics/__init__.py: exact accumulation
on the host, in numpy (predictions are tiny beside the model's work; the
eval loop copies each batch's outputs to the host once). Every metric
of the MetricConfig oneof: ``auc``, ``multiclass_auc``, ``grouped_auc``
(named ``grouped_auc_<grouping_key>``, as the JAX package names it),
``xauc``, ``grouped_xauc`` (named ``grouped_xauc_<grouping_key>``),
``normalized_entropy``, ``recall_at_k`` (named ``recall@<top_k>``),
``accuracy``, ``mean_absolute_error`` and ``mean_squared_error``; and
``TrainMetricWrapper``, the decayed running value of a train metric.
XAUC and GroupedXAUC draw their pairs with ``np.random.default_rng(0)``
in the JAX package's order, so both packages give the same value. Only
one process: there is no cross-host ``sync``.
"""

from typing import Any, Dict, List, Optional

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


class MulticlassAUC:
    """One-vs-rest AUC over the classes of ``preds`` [N, C]: the mean (or,
    with ``average: "weighted"``, the class-count weighted mean) of the
    classes that have both a positive and a negative."""

    def __init__(self, thresholds: int = 200, average: str = "macro", **kw):
        self.average = average
        self.reset()

    def reset(self) -> None:
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def update(self, preds, labels, **kw) -> None:
        self._preds.append(np.asarray(preds))
        self._labels.append(np.asarray(labels).reshape(-1))

    def compute(self) -> float:
        p = np.concatenate(self._preds)
        y = np.concatenate(self._labels).astype(int)
        aucs, weights = [], []
        for c in range(p.shape[1]):
            a = _auc(p[:, c], (y == c).astype(np.float32))
            if not np.isnan(a):
                aucs.append(a)
                weights.append((y == c).sum())
        if not aucs:
            return float("nan")
        if self.average == "weighted":
            return float(np.average(aucs,
                                    weights=np.asarray(weights, np.float64)))
        return float(np.mean(aucs))


class XAUC:
    """Pairwise order accuracy on continuous labels over sampled pairs:
    ``sample_ratio`` of the n(n-1)/2 pairs (at most ``max_pairs``, at
    least one), drawn with replacement from ``default_rng(0)``; pairs of
    equal labels do not count."""

    def __init__(self, sample_ratio: float = 1e-3,
                 max_pairs: Optional[int] = None, in_batch: bool = False,
                 **kw) -> None:
        self.sample_ratio = sample_ratio
        self.max_pairs = max_pairs
        self.reset()

    def reset(self) -> None:
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def update(self, preds, labels, **kw) -> None:
        self._preds.append(np.asarray(preds).reshape(-1))
        self._labels.append(np.asarray(labels).reshape(-1))

    def compute(self) -> float:
        p = np.concatenate(self._preds)
        y = np.concatenate(self._labels)
        n = len(p)
        n_pairs = int(n * (n - 1) / 2 * self.sample_ratio)
        if self.max_pairs:
            n_pairs = min(n_pairs, int(self.max_pairs))
        n_pairs = max(n_pairs, 1)
        rng = np.random.default_rng(0)
        i = rng.integers(0, n, n_pairs)
        j = rng.integers(0, n, n_pairs)
        valid = y[i] != y[j]
        if valid.sum() == 0:
            return float("nan")
        concordant = ((p[i] - p[j]) * (y[i] - y[j]) > 0) & valid
        return float(concordant.sum() / valid.sum())


class GroupedXAUC:
    """The mean over the groups of ``grouping_key`` (ascending) of XAUC
    on at most ``max_pairs_per_group`` pairs a group, drawn with
    replacement within the group from one ``default_rng(0)``."""

    def __init__(self, grouping_key: str, max_pairs_per_group: int = 100,
                 **kw) -> None:
        self.grouping_key = grouping_key
        # a uint64 field comes out of the config as a string
        self.max_pairs = int(max_pairs_per_group)
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
        p = np.concatenate(self._preds)
        y = np.concatenate(self._labels)
        k = np.concatenate(self._keys)
        rng = np.random.default_rng(0)
        scores = []
        for key in np.unique(k):
            m = np.flatnonzero(k == key)
            if len(m) < 2:
                continue
            n_pairs = min(self.max_pairs, len(m) * (len(m) - 1) // 2)
            i = rng.choice(m, n_pairs)
            j = rng.choice(m, n_pairs)
            valid = y[i] != y[j]
            if valid.sum() == 0:
                continue
            conc = ((p[i] - p[j]) * (y[i] - y[j]) > 0) & valid
            scores.append(conc.sum() / valid.sum())
        return float(np.mean(scores)) if scores else float("nan")


class NormalizedEntropy:
    """Cross entropy over the entropy of the base rate, both in float64,
    predictions clipped to [eta, 1 - eta]."""

    def __init__(self, eta: float = 1e-12, **kw) -> None:
        self.eta = eta
        self.reset()

    def reset(self) -> None:
        self._ce_sum = 0.0
        self._pos = 0.0
        self._n = 0

    def update(self, preds, labels, **kw) -> None:
        p = np.clip(np.asarray(preds, np.float64).reshape(-1), self.eta,
                    1 - self.eta)
        y = np.asarray(labels, np.float64).reshape(-1)
        self._ce_sum += float(
            -(y * np.log(p) + (1 - y) * np.log(1 - p)).sum())
        self._pos += float(y.sum())
        self._n += len(y)

    def compute(self) -> float:
        if self._n == 0:
            return float("nan")
        base = np.clip(self._pos / self._n, self.eta, 1 - self.eta)
        h = -(base * np.log(base) + (1 - base) * np.log(1 - base))
        return float(self._ce_sum / self._n / h)


class Accuracy:
    """Share of correct predictions: ``preds > threshold`` against
    ``labels > 0.5``, or for [N, C] predictions the label among the
    ``top_k`` classes."""

    def __init__(self, threshold: float = 0.5, top_k: int = 1, **kw) -> None:
        self.threshold = threshold
        self.top_k = top_k
        self.reset()

    def reset(self) -> None:
        self._correct = 0.0
        self._n = 0

    def update(self, preds, labels, **kw) -> None:
        p = np.asarray(preds)
        y = np.asarray(labels).reshape(-1)
        if p.ndim > 1 and p.shape[-1] > 1:
            topk = np.argsort(-p, axis=-1)[:, :self.top_k]
            self._correct += float(
                (topk == y[:, None].astype(int)).any(1).sum())
        else:
            self._correct += float(
                ((p.reshape(-1) > self.threshold) == (y > 0.5)).sum())
        self._n += len(y)

    def compute(self) -> float:
        return float(self._correct / max(self._n, 1))


class MeanAbsoluteError:
    def __init__(self, **kw) -> None:
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._n = 0

    def update(self, preds, labels, **kw) -> None:
        d = np.asarray(preds).reshape(-1) - np.asarray(labels).reshape(-1)
        self._sum += float(np.abs(d).sum())
        self._n += d.shape[0]

    def compute(self) -> float:
        return float(self._sum / max(self._n, 1))


class MeanSquaredError(MeanAbsoluteError):
    def update(self, preds, labels, **kw) -> None:
        d = np.asarray(preds).reshape(-1) - np.asarray(labels).reshape(-1)
        self._sum += float((d * d).sum())
        self._n += d.shape[0]


class TrainMetricWrapper:
    """A train metric's decayed running value: every ``decay_step``
    updates the inner metric's value folds into the running one with
    ``decay_rate`` (a NaN value is skipped) and the inner metric starts
    over; before the first fold ``compute`` gives the inner value."""

    def __init__(self, inner, decay_rate: float = 0.9,
                 decay_step: int = 100) -> None:
        self._inner = inner
        self._decay_rate = decay_rate
        self._decay_step = decay_step
        self._running: Optional[float] = None
        self._count = 0

    def reset(self) -> None:
        self._inner.reset()

    def update(self, preds, labels, **kw) -> None:
        self._inner.update(preds, labels, **kw)
        self._count += 1
        if self._count % self._decay_step == 0:
            v = self._inner.compute()
            if not np.isnan(v):
                self._running = (v if self._running is None else
                                 self._decay_rate * self._running
                                 + (1 - self._decay_rate) * v)
            self._inner.reset()

    def compute(self) -> float:
        if self._running is None:
            return self._inner.compute()
        return float(self._running)


_METRIC_CLASSES = {
    "auc": AUC,
    "multiclass_auc": MulticlassAUC,
    "grouped_auc": GroupedAUC,
    "xauc": XAUC,
    "grouped_xauc": GroupedXAUC,
    "normalized_entropy": NormalizedEntropy,
    "recall_at_k": RecallAtK,
    "accuracy": Accuracy,
    "mean_absolute_error": MeanAbsoluteError,
    "mean_squared_error": MeanSquaredError,
}


def create_metric(metric_config) -> Dict[str, Any]:
    """MetricConfig proto -> {name, metric, config}."""
    from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

    which = metric_config.WhichOneof("metric")
    cfg = getattr(metric_config, which)
    kwargs = config_to_kwargs(cfg)
    name = which
    if which in ("grouped_auc", "grouped_xauc"):
        name = f"{which}_{cfg.grouping_key}"
    elif which == "recall_at_k":
        name = f"recall@{cfg.top_k}"
    return {"name": name, "metric": _METRIC_CLASSES[which](**kwargs),
            "config": kwargs}

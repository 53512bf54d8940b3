"""Exact global semantic-ID quality statistics.

A copy of torcheasyrec_tpu/utils/sid/quality.py (the port imports
nothing of the JAX package), kept equal to it: global collision metrics
(unique-SID / no-collision rate, singleton rate, max bucket, Gini,
entropy vs capacity) plus per-layer code-usage metrics (coverage, dead
codes, perplexity), an exact streaming accumulator over batches, and a
before/after delta view. Host-side numpy: SID audits are IO-bound,
there is no device work here.
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

_INT64_MAX = np.iinfo(np.int64).max


@dataclass(frozen=True)
class SidQualityMetrics:
    """Global collision/distribution metrics over one SID cohort."""

    total: int
    unique_sid: int
    no_collision_rate: float
    uniquely_identified_item_rate: float
    max_collision: int
    gini: float
    entropy: float
    max_entropy: float
    entropy_ratio: float


@dataclass(frozen=True)
class SidLayerQualityMetrics:
    """Code-usage metrics for one SID layer."""

    layer: int
    codebook_size: int
    coverage: float
    dead_codes: int
    perplexity: float


@dataclass(frozen=True)
class SidQualityResult:
    metrics: SidQualityMetrics
    layer_metrics: Tuple[SidLayerQualityMetrics, ...]
    top_sids: Optional[Tuple[Tuple[str, int], ...]] = None


def compute_entropy(counts) -> float:
    """Shannon entropy in nats of a count distribution."""
    c = np.asarray(counts, np.float64)
    total = c.sum()
    if total <= 0:
        return 0.0
    p = c[c > 0] / total
    return float(-(p * np.log(p)).sum())


def compute_gini(counts) -> float:
    """Gini coefficient of occupied bucket sizes, in [0, 1)."""
    x = np.sort(np.asarray(counts, np.float64))
    n = x.size
    s = x.sum()
    if n == 0 or s == 0:
        return 0.0
    # closed form over ascending order: G = (2*sum(i*x_i))/(n*S) - (n+1)/n
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(2.0 * (i * x).sum() / (n * s) - (n + 1) / n)


def valid_code_rows(codes: np.ndarray, codebook: Sequence[int]) -> np.ndarray:
    """Mask of rows whose every layer code is inside [0, size)."""
    codes = np.asarray(codes)
    sizes = np.asarray(list(codebook), np.int64)
    if codes.ndim != 2 or codes.shape[1] != sizes.size:
        raise ValueError(
            f"codes shape {codes.shape} incompatible with codebook "
            f"{list(codebook)}"
        )
    return ((codes >= 0) & (codes < sizes[None, :])).all(axis=1)


def _mixed_radix(codes: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    keys = codes[:, 0].astype(np.int64)
    for layer in range(1, sizes.size):
        keys = keys * sizes[layer] + codes[:, layer]
    return keys


class SidQualityAccumulator:
    """Streams batches of in-range SID codes; finalize() is exact."""

    def __init__(self, codebook: Sequence[int],
                 top_sids: Optional[int] = None) -> None:
        sizes = np.asarray(list(codebook), np.int64)
        if sizes.size == 0 or (sizes <= 0).any():
            raise ValueError(f"codebook must be positive sizes: {codebook}")
        capacity = math.prod(int(s) for s in sizes)
        if capacity > _INT64_MAX:
            raise ValueError(
                f"codebook capacity {capacity} exceeds int64; exact "
                "collision accounting is not supported at that scale"
            )
        if top_sids is not None and top_sids <= 0:
            raise ValueError(f"top_sids must be positive, got {top_sids}")
        self._sizes = sizes
        self._capacity = capacity
        self._top_sids = top_sids
        self._key_chunks: List[np.ndarray] = []
        self._layer_hist = [np.zeros(int(s), np.int64) for s in sizes]
        self._total = 0
        self._done = False

    @property
    def total(self) -> int:
        return self._total

    def update(self, codes: np.ndarray) -> None:
        if self._done:
            raise ValueError("accumulator already finalized")
        codes = np.asarray(codes)
        if codes.ndim != 2 or codes.shape[1] != self._sizes.size:
            raise ValueError(
                f"codes shape {codes.shape} != (N, {self._sizes.size})"
            )
        if codes.shape[0] == 0:
            return
        if not valid_code_rows(codes, self._sizes).all():
            raise ValueError("codes contain out-of-codebook values")
        codes = codes.astype(np.int64, copy=False)
        self._key_chunks.append(_mixed_radix(codes, self._sizes))
        for layer, hist in enumerate(self._layer_hist):
            hist += np.bincount(codes[:, layer], minlength=hist.size)
        self._total += codes.shape[0]

    def finalize(self) -> SidQualityResult:
        if self._done:
            raise ValueError("accumulator already finalized")
        self._done = True
        if not self._total:
            raise ValueError("no SID codes accumulated; nothing to report")
        keys = np.concatenate(self._key_chunks)
        self._key_chunks = []
        sid_keys, counts = np.unique(keys, return_counts=True)
        entropy = compute_entropy(counts)
        max_entropy = math.log(self._capacity)
        metrics = SidQualityMetrics(
            total=self._total,
            unique_sid=int(sid_keys.size),
            no_collision_rate=sid_keys.size / self._total,
            uniquely_identified_item_rate=int((counts == 1).sum())
            / self._total,
            max_collision=int(counts.max()),
            gini=compute_gini(counts),
            entropy=entropy,
            max_entropy=max_entropy,
            entropy_ratio=entropy / max_entropy if max_entropy else float(
                "nan"
            ),
        )
        layers = []
        for layer, hist in enumerate(self._layer_hist):
            used = int((hist > 0).sum())
            layers.append(SidLayerQualityMetrics(
                layer=layer,
                codebook_size=int(hist.size),
                coverage=used / hist.size,
                dead_codes=int(hist.size) - used,
                perplexity=float(math.exp(compute_entropy(hist))),
            ))
        top: Optional[Tuple[Tuple[str, int], ...]] = None
        if self._top_sids:
            order = np.argsort(-counts, kind="stable")[: self._top_sids]
            # decode mixed-radix keys back into per-layer codes
            rows = []
            for k, c in zip(sid_keys[order].tolist(),
                            counts[order].tolist()):
                digits = []
                for s in self._sizes[::-1].tolist():
                    digits.append(k % s)
                    k //= s
                rows.append((",".join(map(str, digits[::-1])), int(c)))
            top = tuple(rows)
        return SidQualityResult(metrics, tuple(layers), top)


def compare_sid_quality(before: SidQualityResult,
                        after: SidQualityResult) -> SidQualityResult:
    """after - before deltas over the same item cohort/codebook."""
    if before.metrics.total != after.metrics.total:
        raise ValueError("before/after must cover the same item cohort")
    if len(before.layer_metrics) != len(after.layer_metrics):
        raise ValueError("before/after layer counts differ")
    layer_deltas = []
    for b, a in zip(before.layer_metrics, after.layer_metrics):
        if b.layer != a.layer or b.codebook_size != a.codebook_size:
            raise ValueError("before/after use different codebooks")
        layer_deltas.append(SidLayerQualityMetrics(
            layer=a.layer, codebook_size=a.codebook_size,
            coverage=a.coverage - b.coverage,
            dead_codes=a.dead_codes - b.dead_codes,
            perplexity=a.perplexity - b.perplexity,
        ))
    bm, am = before.metrics, after.metrics
    return SidQualityResult(
        SidQualityMetrics(
            total=am.total - bm.total,
            unique_sid=am.unique_sid - bm.unique_sid,
            no_collision_rate=am.no_collision_rate - bm.no_collision_rate,
            uniquely_identified_item_rate=(
                am.uniquely_identified_item_rate
                - bm.uniquely_identified_item_rate
            ),
            max_collision=am.max_collision - bm.max_collision,
            gini=am.gini - bm.gini,
            entropy=am.entropy - bm.entropy,
            max_entropy=am.max_entropy - bm.max_entropy,
            entropy_ratio=am.entropy_ratio - bm.entropy_ratio,
        ),
        tuple(layer_deltas),
    )

"""Best-effort semantic-ID collision resolution (pure numpy core).

A copy of torcheasyrec_tpu/utils/sid/collision.py (the port imports
nothing of the JAX package), kept equal to it. Semantics:

* A bucket is the full code tuple; overflow items may only move within
  their *band* (all layers but the last) by changing the LAST layer
  code — that is what keeps a relocated SID semantically close.
* Deterministic processing order: rows are ranked within their bucket
  by a SplitMix64 hash of the item id, so results are independent of
  input row order. The first ``capacity`` ranks stay; the rest are
  overflow, relocated greedily first-fit over their ordered candidate
  last-codes (skipping the origin code, never replacing a skipped
  draw). An overflow item with no free candidate keeps its original
  SID over capacity — every input row is preserved.
* The random strategy draws candidates with replacement from the full
  last-layer space, seeded only by the item id (rerun-stable).
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(values: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer over uint64 values."""
    with np.errstate(over="ignore"):
        v = values.astype(np.uint64, copy=False) + np.uint64(_GOLDEN)
        v = (v ^ (v >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        v = (v ^ (v >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return v ^ (v >> np.uint64(31))


def stable_order_hash(item_ids: np.ndarray) -> np.ndarray:
    """Order-independent uint64 tie-break hash per item id."""
    item_ids = np.asarray(item_ids)
    if item_ids.ndim != 1:
        raise ValueError(f"item_ids must be 1-D, got {item_ids.shape}")
    if np.issubdtype(item_ids.dtype, np.integer):
        base = item_ids.astype(np.uint64, copy=False)
    else:
        # FNV-1a fold of the utf-8 string form (stable across runs,
        # unlike python hash())
        base = np.empty(item_ids.shape[0], np.uint64)
        for i, t in enumerate(item_ids):
            h = 0xCBF29CE484222325
            for b in str(t).encode("utf-8"):
                h = ((h ^ b) * 0x100000001B3) & _MASK64
            base[i] = h
    return splitmix64(base)


@dataclass(frozen=True)
class CollisionStats:
    total_items: int
    raw_collision_buckets: int  # buckets over capacity before resolution
    final_collision_buckets: int
    relocated_count: int
    unresolved_count: int
    max_final_bucket_size: int


@dataclass(frozen=True)
class CollisionResult:
    """Row-aligned resolved last codes + diagnostics.

    ``slot_indices`` is each row's 1-based rank within its FINAL
    bucket; final bucket = (band, resolved last code).
    """

    resolved_last_codes: np.ndarray  # [N] int64
    slot_indices: np.ndarray  # [N] int64, 1-based
    unresolved_rows: np.ndarray  # original row indices kept over capacity
    overflow_rows: np.ndarray  # rows that were ranked past capacity
    stats: CollisionStats


def _band_keys(codes: np.ndarray, layer_sizes: Sequence[int]) -> np.ndarray:
    """Mixed-radix key of every layer except the last."""
    n, L = codes.shape
    if L == 1:
        return np.zeros(n, np.int64)
    keys = codes[:, 0].astype(np.int64)
    for layer in range(1, L - 1):
        keys = keys * int(layer_sizes[layer]) + codes[:, layer]
    return keys


def random_candidates(item_ids: np.ndarray, last_size: int,
                      num_candidates: int) -> np.ndarray:
    """Deterministic with-replacement draws over the full last layer."""
    if last_size < 2:
        raise ValueError("random candidates require last_size >= 2")
    k = min(int(num_candidates), last_size - 1)
    h = stable_order_hash(item_ids)
    draws = np.arange(k, dtype=np.uint64)
    with np.errstate(over="ignore"):
        mixed = splitmix64(h[:, None] + draws[None, :] * np.uint64(_GOLDEN))
    return (mixed % np.uint64(last_size)).astype(np.int64)


def resolve_collisions(
    item_ids: np.ndarray,
    codes: np.ndarray,
    layer_sizes: Sequence[int],
    capacity: int,
    candidate_last_codes: Optional[np.ndarray] = None,
    num_random_candidates: Optional[int] = None,
) -> CollisionResult:
    """Relocate over-capacity bucket members within their band.

    Args:
        item_ids: [N] ids aligned with codes (used only for ordering /
            random seeding; duplicates stay independent items).
        codes: [N, L] int SID matrix, in-range for ``layer_sizes``.
        layer_sizes: per-layer codebook cardinality.
        capacity: max retained items per SID bucket (>= 1).
        candidate_last_codes: [N, K] ordered last-layer candidates per
            INPUT row (only overflow rows' candidates are read), or
            None with ``num_random_candidates`` for the random strategy.
        num_random_candidates: draw count for the random strategy.
    """
    item_ids = np.asarray(item_ids)
    codes = np.asarray(codes)
    sizes = [int(s) for s in layer_sizes]
    if codes.ndim != 2 or codes.shape[1] != len(sizes):
        raise ValueError(
            f"codes shape {codes.shape} != (N, {len(sizes)})"
        )
    if item_ids.shape[0] != codes.shape[0]:
        raise ValueError("item_ids and codes row counts differ")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if codes.size and (
        (codes < 0).any() or (codes >= np.asarray(sizes)[None, :]).any()
    ):
        raise ValueError(
            f"codes out of range for layer_sizes {sizes}; check that the "
            "codebook matches the model that produced the SID table"
        )

    n = codes.shape[0]
    last_size = sizes[-1]
    last = codes[:, -1].astype(np.int64)
    band = _band_keys(codes, sizes)
    order_hash = stable_order_hash(item_ids)

    # rank rows within their (band, last) bucket in hash order
    sorted_rows = np.lexsort((order_hash, last, band))
    sb, sl = band[sorted_rows], last[sorted_rows]
    is_first = np.ones(n, bool)
    if n > 1:
        is_first[1:] = (sb[1:] != sb[:-1]) | (sl[1:] != sl[:-1])
    bucket_starts = np.flatnonzero(is_first)
    bucket_of_sorted = np.cumsum(is_first) - 1
    ranks_sorted = np.arange(n, dtype=np.int64) - bucket_starts[
        bucket_of_sorted
    ]
    bucket_counts = np.diff(np.append(bucket_starts, n))

    slot_indices = np.empty(n, np.int64)
    slot_indices[sorted_rows] = ranks_sorted + 1
    resolved_last = last.copy()

    overflow_sorted = ranks_sorted >= capacity
    overflow_rows = sorted_rows[overflow_sorted]
    raw_collision_buckets = int((bucket_counts > capacity).sum())
    if overflow_rows.size == 0:
        occ = bucket_counts
        return CollisionResult(
            resolved_last, slot_indices,
            np.empty(0, np.int64), overflow_rows,
            CollisionStats(
                total_items=n,
                raw_collision_buckets=0,
                final_collision_buckets=0,
                relocated_count=0,
                unresolved_count=0,
                max_final_bucket_size=int(occ.max()) if n else 0,
            ),
        )

    if candidate_last_codes is not None:
        cands = np.asarray(candidate_last_codes)
        if cands.ndim != 2 or cands.shape[0] != n:
            raise ValueError(
                f"candidate_last_codes must be [N, K], got {cands.shape}"
            )
        if cands.size and ((cands < 0).any() or (cands >= last_size).any()):
            raise ValueError("candidate last codes out of range")
        overflow_cands = cands[overflow_rows]
    elif num_random_candidates:
        overflow_cands = random_candidates(
            item_ids[overflow_rows], last_size, num_random_candidates
        )
    else:
        raise ValueError(
            "collision plan has overflow rows: supply "
            "candidate_last_codes or num_random_candidates"
        )

    # occupancy per bucket key, seeded with the capped survivors;
    # restricted to bands that have overflow (others never change)
    bucket_keys = (
        sb[bucket_starts] * last_size + sl[bucket_starts]
    )
    overflow_bands = np.unique(band[overflow_rows])
    touched = np.isin(sb[bucket_starts], overflow_bands)
    occupancy = dict(zip(
        bucket_keys[touched].tolist(),
        np.minimum(bucket_counts, capacity)[touched].tolist(),
    ))

    relocated = 0
    unresolved = []
    get = occupancy.get
    for row, cand_row in zip(
        overflow_rows.tolist(), overflow_cands.tolist()
    ):
        prefix = int(band[row]) * last_size
        origin = int(last[row])
        for cand in cand_row:
            if cand == origin:
                continue
            key = prefix + cand
            cnt = get(key, 0)
            if cnt < capacity:
                occupancy[key] = cnt + 1
                resolved_last[row] = cand
                slot_indices[row] = cnt + 1
                relocated += 1
                break
        else:
            unresolved.append(row)
            key = prefix + origin
            cnt = get(key, 0) + 1
            occupancy[key] = cnt
            slot_indices[row] = cnt

    # final bucket sizes: untouched buckets keep their raw counts,
    # touched bands read back from the occupancy map
    final_counts = np.asarray(list(occupancy.values()), np.int64)
    untouched_counts = bucket_counts[~touched]
    final_collisions = int((final_counts > capacity).sum()) + int(
        (untouched_counts > capacity).sum()
    )
    max_final = max(
        int(final_counts.max()) if final_counts.size else 0,
        int(untouched_counts.max()) if untouched_counts.size else 0,
    )
    return CollisionResult(
        resolved_last, slot_indices,
        np.asarray(unresolved, np.int64), overflow_rows,
        CollisionStats(
            total_items=n,
            raw_collision_buckets=raw_collision_buckets,
            final_collision_buckets=final_collisions,
            relocated_count=relocated,
            unresolved_count=len(unresolved),
            max_final_bucket_size=max_final,
        ),
    )


def group_items(
    item_ids: np.ndarray,
    codes: np.ndarray,
    layer_sizes: Sequence[int],
    resolved_last_codes: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR grouping of rows by (resolved) SID.

    Returns (sid_codes [B, L], offsets [B+1], row_order [N]): rows
    ``row_order[offsets[i]:offsets[i+1]]`` share ``sid_codes[i]``.
    """
    codes = np.asarray(codes)
    final = codes.astype(np.int64, copy=True)
    if resolved_last_codes is not None:
        final[:, -1] = np.asarray(resolved_last_codes)
    last_size = int(layer_sizes[-1])
    keys = _band_keys(final, layer_sizes) * last_size + final[:, -1]
    order_hash = stable_order_hash(np.asarray(item_ids))
    row_order = np.lexsort((order_hash, keys))
    sk = keys[row_order]
    n = sk.size
    is_first = np.ones(n, bool)
    if n > 1:
        is_first[1:] = sk[1:] != sk[:-1]
    starts = np.flatnonzero(is_first)
    offsets = np.append(starts, n).astype(np.int64)
    sid_codes = final[row_order[starts]]
    return sid_codes, offsets, row_order

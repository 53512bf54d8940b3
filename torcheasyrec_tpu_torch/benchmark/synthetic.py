"""Criteo-statistics synthetic dataset with planted learnable structure.

The port's own copy of torcheasyrec_tpu/benchmark/synthetic.py
(``generate``, ``ensure_dataset``, ``_latent`` and the bucket list;
pure numpy and pyarrow), so that the port's copies of the criteo_synth
configs (``configs/criteo_synth/``) train on the same rows as the JAX
package's, and their AUCs stand beside the labels pinned in
``configs/base_eval_metric.json``. From the same seed it writes the same
rows: the streams are drawn in the same order, every later column after
every earlier one.

Shape: 26 categorical columns (``cat_<j>``, Criteo-Terabyte bucket
counts capped at 100 000, zipf-ish ids) and 13 dense ones (``int_<i>``,
standard normal). Labels: ``label`` (click) from a planted logit of
per-id latent effects, dense terms and three interactions; ``conversion``
(observed only on clicks) from a second logit; ``label_seq`` from a
click-history column (``click_seq``, ``tgt_item``) for sequence models;
``user_taste``, ``item_id``, ``item_cluster`` and ``pos_label`` for
two-tower models; ``group_id`` (``cat_10``) for grouped metrics.
"""

import os
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

# Criteo-Terabyte cardinalities (reference deepfm_criteo.config), capped
# so the synthetic id space is dense enough to learn from 256k rows
_CAP = 100_000
CRITEO_BUCKETS: List[int] = [min(n, _CAP) for n in [
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
    40000000, 590152, 12973, 108, 36,
]]
N_DENSE = 13

# sequence-signal vocabulary: N_ITEMS ids in N_CLUSTERS taste clusters
N_ITEMS = 2000
N_CLUSTERS = 50
_STRIDE = N_ITEMS // N_CLUSTERS
SEQ_LEN = 30


def _latent(values: np.ndarray, feat_idx: int, scale: float,
            salt: int = 0) -> np.ndarray:
    """Deterministic per-value latent effect ~ N(0, scale) via a
    counter-based hash (splitmix64), no table materialization."""
    x = values.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    x ^= np.uint64(feat_idx * 2654435761 + salt * 40503 + 1)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    # two 32-bit halves -> Box-Muller normal
    u1 = ((x >> np.uint64(32)).astype(np.float64) + 1.0) / 4294967297.0
    u2 = (x & np.uint64(0xFFFFFFFF)).astype(np.float64) / 4294967296.0
    return (
        np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2) * scale
    ).astype(np.float32)


def generate(
    path: str,
    num_rows: int,
    seed: int = 0,
    buckets: Optional[List[int]] = None,
    rows_per_file: int = 0,
) -> List[str]:
    """Write the synthetic dataset as parquet; returns file paths."""
    buckets = buckets or CRITEO_BUCKETS
    rng = np.random.default_rng(seed)
    n = num_rows

    cats = [
        # zipf-ish popularity (Criteo ids are heavy-tailed): squaring a
        # uniform concentrates mass on small ids
        np.minimum(
            (rng.random(n) ** 2.2 * b).astype(np.int64), b - 1
        )
        for b in buckets
    ]
    dense = [rng.normal(size=n).astype(np.float32) for _ in range(N_DENSE)]

    # planted logit: per-feature scales decay so early features matter
    logit = np.zeros(n, np.float32)
    for j, c in enumerate(cats):
        logit += _latent(c, j, 0.55 / (1.0 + 0.35 * j))
    for i, x in enumerate(dense):
        w = 0.35 / (1.0 + 0.3 * i)
        logit += w * x + 0.12 * w * (x * x - 1.0)
    # interactions only nonlinear models can fully exploit
    logit += 0.8 * _latent(
        cats[1] * np.int64(1315423911) + cats[2], 101, 1.0
    )
    logit += 0.6 * _latent(cats[3], 102, 1.0) * np.tanh(dense[0])
    logit += 0.5 * np.tanh(dense[1] * dense[2])

    z = (logit - logit.mean()) / max(logit.std(), 1e-6) * 1.6 - 1.1
    p_click = 1.0 / (1.0 + np.exp(-z))
    click = (rng.random(n) < p_click).astype(np.float32)

    logit2 = np.zeros(n, np.float32)
    for j, c in enumerate(cats[:8]):
        logit2 += _latent(c, j, 0.5 / (1.0 + 0.3 * j), salt=7)
    logit2 += 0.5 * np.tanh(dense[3]) + 0.4 * dense[4]
    logit2 += 0.7 * _latent(cats[0], 103, 1.0, salt=7) * np.tanh(dense[5])
    z2 = (logit2 - logit2.mean()) / max(logit2.std(), 1e-6) * 1.5 - 1.6
    p_conv = 1.0 / (1.0 + np.exp(-z2))
    conversion = click * (rng.random(n) < p_conv).astype(np.float32)

    # ---- sequence signal (label_seq head) ----
    taste = rng.integers(0, N_CLUSTERS, n)
    seq_lens = rng.integers(5, SEQ_LEN + 1, n)
    in_cluster = (rng.random((n, SEQ_LEN)) ** 1.8 * _STRIDE).astype(
        np.int64
    )
    hist = taste[:, None] * _STRIDE + in_cluster
    noise_mask = rng.random((n, SEQ_LEN)) < 0.2
    hist = np.where(
        noise_mask, rng.integers(0, N_ITEMS, (n, SEQ_LEN)), hist
    )
    tgt_from_taste = rng.random(n) < 0.65
    tgt = np.where(
        tgt_from_taste,
        taste * _STRIDE
        + (rng.random(n) ** 1.8 * _STRIDE).astype(np.int64),
        rng.integers(0, N_ITEMS, n),
    )
    # graded similarity: fraction of (valid) history in the target's
    # cluster — an attention model can measure this, a no-sequence
    # model cannot
    valid = np.arange(SEQ_LEN)[None, :] < seq_lens[:, None]
    same = (hist // _STRIDE == (tgt // _STRIDE)[:, None]) & valid
    sim = same.sum(axis=1) / np.maximum(seq_lens, 1)
    logit3 = 2.6 * sim.astype(np.float32)
    logit3 += _latent(tgt, 104, 0.45)       # weak direct item effect
    logit3 += 0.3 * dense[0] + _latent(cats[4], 105, 0.3)
    z3 = (logit3 - logit3.mean()) / max(logit3.std(), 1e-6) * 1.5 - 0.9
    label_seq = (
        rng.random(n) < 1.0 / (1.0 + np.exp(-z3))
    ).astype(np.float32)
    seq_strs = [
        ";".join(map(str, row[:ln]))
        for row, ln in zip(hist.tolist(), seq_lens.tolist())
    ]

    # ---- match-model signal (dssm benchmark): each row carries a
    # CLICKED item, drawn from the user's taste cluster 80% of the
    # time, plus the user's taste id as a user-side feature — a
    # two-tower model must align taste and item embeddings to rank the
    # positive above sampled negatives (drawn after all other streams
    # so earlier pinned labels stay valid) ----
    pos_in_cluster = rng.random(n) < 0.8
    pos_in_draw = rng.integers(0, _STRIDE, n)
    pos_uniform = rng.integers(0, N_ITEMS, n)
    item_id = np.where(
        pos_in_cluster, taste * _STRIDE + pos_in_draw, pos_uniform
    )

    cols: Dict[str, pa.Array] = {}
    for i, x in enumerate(dense):
        cols[f"int_{i}"] = pa.array(x)
    for j, c in enumerate(cats):
        cols[f"cat_{j}"] = pa.array(c)
    cols["label"] = pa.array(click)
    cols["conversion"] = pa.array(conversion)
    cols["tgt_item"] = pa.array(tgt)
    cols["click_seq"] = pa.array(seq_strs)
    cols["label_seq"] = pa.array(label_seq)
    cols["user_taste"] = pa.array(taste)
    cols["item_id"] = pa.array(item_id)
    cols["item_cluster"] = pa.array(item_id // _STRIDE)
    cols["pos_label"] = pa.array(np.ones(n, np.float32))
    # grouping key for grouped metrics: user-ish id
    cols["group_id"] = pa.array(cats[10])
    table = pa.table(cols)

    if rows_per_file and num_rows > rows_per_file:
        os.makedirs(path, exist_ok=True)
        paths = []
        for k in range(0, num_rows, rows_per_file):
            p = os.path.join(path, f"part-{k // rows_per_file:05d}.parquet")
            pq.write_table(table.slice(k, rows_per_file), p)
            paths.append(p)
        return paths
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pq.write_table(table, path)
    return [path]


def ensure_dataset(root: str, train_rows: int = 262144,
                   eval_rows: int = 65536) -> Dict[str, str]:
    """Idempotently materialize train/eval shards under ``root``.

    v2 added the sequence-signal columns (tgt_item/click_seq/label_seq);
    v3 adds the match-model columns (user_taste/item_id/item_cluster/
    pos_label) and the sampler item table. New columns are drawn AFTER
    all earlier streams under the same seed, so labels pinned on older
    versions remain valid.
    """
    train = os.path.join(root, f"criteo_synth_train_{train_rows}_v3.parquet")
    evalp = os.path.join(root, f"criteo_synth_eval_{eval_rows}_v3.parquet")
    items = os.path.join(root, "criteo_synth_items.parquet")
    if not os.path.exists(train):
        generate(train, train_rows, seed=1)
    if not os.path.exists(evalp):
        generate(evalp, eval_rows, seed=2)
    if not os.path.exists(items):
        # graphlearn-layout item table for the negative sampler:
        # id | weight | attrs ("item_id:item_cluster")
        ids = np.arange(N_ITEMS)
        tbl = pa.table({
            "id": pa.array(ids),
            "weight": pa.array(np.ones(N_ITEMS)),
            "attrs": pa.array(
                [f"{i}:{i // _STRIDE}" for i in range(N_ITEMS)]
            ),
        })
        os.makedirs(root, exist_ok=True)
        pq.write_table(tbl, items)
    return {"train": train, "eval": evalp, "items": items}


def generate_hstu(path: str, num_rows: int, seed: int = 0) -> str:
    """Generative-recommender (DLRM-HSTU) rows, the kuairand analogue: a
    history of 8-31 videos and 2-9 candidates a row, with the action
    bitmask labels of two tasks (click 1, like 2). The planted signal is
    each video's popularity (the candidate's embedding) and the match of
    the candidate's cluster with the user's (the history, through the
    attention). The port's copy of the JAX package's ``generate_hstu``:
    the same rows from the same seed."""
    rng = np.random.default_rng(seed)
    n_users, n_videos, n_clusters = 2000, 5000, 50
    stride = n_videos // n_clusters
    rows: Dict[str, list] = {
        "user_id": [], "video_id": [], "item_video_id": [],
        "action_weight": [], "action_timestamp": [], "item_query_time": [],
        "item_action_weight": [], "unused_label": [],
    }
    for _ in range(num_rows):
        uid = int(rng.integers(0, n_users))
        pref = uid % n_clusters
        lu = int(rng.integers(8, 32))
        lc = int(rng.integers(2, 10))
        hist = [
            int(pref * stride + rng.integers(0, stride))
            if rng.random() < 0.8 else int(rng.integers(0, n_videos))
            for _ in range(lu)
        ]
        cands = [int(rng.integers(0, n_videos)) for _ in range(lc)]
        weights = []
        for c in cands:
            base = 0.05 + 0.5 * ((c * 7919) % n_videos) / n_videos
            p_click = min(
                base + (0.4 if c // stride == pref else 0.0), 0.95
            )
            click = rng.random() < p_click
            like = click and rng.random() < 0.3
            weights.append(int(click) + 2 * int(like))
        ts = sorted(rng.integers(0, 10 ** 6, lu).tolist())
        rows["user_id"].append(uid)
        rows["video_id"].append(";".join(map(str, hist)))
        rows["item_video_id"].append(";".join(map(str, cands)))
        rows["action_weight"].append(
            ";".join(str(int(rng.integers(0, 4))) for _ in range(lu))
        )
        rows["action_timestamp"].append(";".join(map(str, ts)))
        rows["item_query_time"].append(
            ";".join(str(10 ** 6) for _ in range(lc))
        )
        rows["item_action_weight"].append(";".join(map(str, weights)))
        rows["unused_label"].append(0.0)
    tbl = pa.table({k: pa.array(v) for k, v in rows.items()})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pq.write_table(tbl, path)
    return path


def ensure_hstu_dataset(root: str, train_rows: int = 20480,
                        eval_rows: int = 4096) -> Dict[str, str]:
    """Idempotently materialize the hstu_synth shards under ``root``:
    train rows from seed 11, eval rows from seed 12."""
    train = os.path.join(root, f"hstu_synth_train_{train_rows}.parquet")
    evalp = os.path.join(root, f"hstu_synth_eval_{eval_rows}.parquet")
    if not os.path.exists(train):
        generate_hstu(train, train_rows, seed=11)
    if not os.path.exists(evalp):
        generate_hstu(evalp, eval_rows, seed=12)
    return {"train": train, "eval": evalp}

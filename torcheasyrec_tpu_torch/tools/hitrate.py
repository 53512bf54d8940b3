"""Top-k hitrate of retrieval towers' embeddings.

Counterpart of torcheasyrec_tpu/tools/hitrate.py, in numpy: given query
(user) embeddings with their ground-truth item ids and an item embedding
table, the hitrate is the mean over queries of the share of a query's
ground truth among its top-k items by brute-force similarity (ties to
the lower item row, as ``jax.lax.top_k`` breaks them).

python -m torcheasyrec_tpu_torch.tools.hitrate \
  --query_path q.parquet --item_path items.parquet --top_k 100
query schema: id | embedding (list<float>) | gt_items (list<int> or str)
item schema:  id | embedding (list<float>)
"""

import argparse
import json
from typing import List, Tuple

import numpy as np
import pyarrow.parquet as pq


def _load_embeddings(path: str, emb_col: str = "embedding"):
    t = pq.read_table(path)
    ids = t.column(t.schema.names[0]).to_numpy(zero_copy_only=False)
    emb = np.stack(t.column(emb_col).to_numpy(zero_copy_only=False))
    return ids.astype(np.int64), emb.astype(np.float32), t


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)


def compute_hitrate(
    query_emb: np.ndarray,  # [Q, D]
    gt_items: List[List[int]],
    item_ids: np.ndarray,  # [N]
    item_emb: np.ndarray,  # [N, D]
    top_k: int = 100,
    batch: int = 1024,
    similarity: str = "inner_product",
) -> Tuple[float, np.ndarray]:
    """(mean hitrate, per-query hitrate); a query without ground truth
    counts 0, as in the JAX package."""
    items = np.asarray(item_emb, np.float32)
    queries = np.asarray(query_emb, np.float32)
    if similarity == "cosine":
        items, queries = _normalize(items), _normalize(queries)
    hits = np.zeros(len(queries), np.float64)
    for s in range(0, len(queries), batch):
        sim = queries[s:s + batch] @ items.T
        # stable on the negated scores: equal scores keep the row order
        idx = np.argsort(-sim, axis=1, kind="stable")[:, :top_k]
        for i, row in enumerate(idx):
            gt = set(gt_items[s + i])
            if not gt:
                continue
            retrieved = {int(item_ids[j]) for j in row}
            hits[s + i] = len(gt & retrieved) / len(gt)
    return float(hits.mean()), hits


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--item_path", required=True)
    parser.add_argument("--gt_column", default="gt_items")
    parser.add_argument("--top_k", type=int, default=100)
    parser.add_argument("--similarity", default="inner_product")
    parser.add_argument("--output_path", default=None)
    args = parser.parse_args()

    q_ids, q_emb, q_tbl = _load_embeddings(args.query_path)
    i_ids, i_emb, _ = _load_embeddings(args.item_path)
    gt_raw = q_tbl.column(args.gt_column).to_pylist()
    gt = [
        [int(x) for x in (
            g if isinstance(g, list) else str(g).split(",")
        ) if str(x).strip()]
        for g in gt_raw
    ]
    hitrate, _ = compute_hitrate(
        q_emb, gt, i_ids, i_emb, args.top_k, similarity=args.similarity)
    result = {"hitrate": hitrate, "top_k": args.top_k,
              "num_queries": len(q_ids)}
    print(json.dumps(result))
    if args.output_path:
        with open(args.output_path, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()

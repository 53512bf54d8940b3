"""TDM trees: building them and a one-query beam search.

Counterpart of torcheasyrec_tpu/tools/tdm/gen_tree.py (numpy and
pyarrow; the same trees, byte for byte, from the same files):

- ``init_tree``: a balanced k-ary tree over the items sorted by id (or
  by a category column, then id);
- ``cluster_tree``: the same over the items ordered by recursive k-means
  of their embeddings, so that similar items share subtrees;
- ``beam_search_retrieval``: a layer-wise beam search for one query.

A tree is written in the TDM sampler's schema: ``node_table.parquet``
(id | weight | attrs: a leaf keeps its item's attrs, an internal node's
attrs are its own id), ``edge_table.parquet`` (parent | child | weight)
and ``root_id.txt``. Internal nodes take ids above the largest item id,
allocated bottom-up, level by level.

python -m torcheasyrec_tpu_torch.tools.tdm.gen_tree \
  --item_input_path items.parquet --output_dir tree [--mode cluster]
"""

import argparse
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq


def _build_from_order(item_ids: np.ndarray, branching: int, id_base: int
                      ) -> Tuple[int, List[Tuple[int, int]]]:
    """(root id, (parent, child) edges) of the balanced tree over the
    ordered leaves: each level's nodes grouped ``branching`` at a time
    under new parents numbered from ``id_base + 1``."""
    next_id = id_base
    level = [int(i) for i in item_ids]
    edges: List[Tuple[int, int]] = []
    while len(level) > 1:
        parents = []
        for s in range(0, len(level), branching):
            next_id += 1
            edges.extend((next_id, c) for c in level[s : s + branching])
            parents.append(next_id)
        level = parents
    return level[0], edges


def init_tree(item_input_path: str, output_dir: str, branching: int = 2,
              category_column: Optional[str] = None) -> None:
    """The items sorted by id (by ``category_column`` first, where the
    item file has it) under a balanced tree."""
    t = pq.read_table(item_input_path)
    ids = t.column(0).to_numpy(zero_copy_only=False).astype(np.int64)
    order = np.argsort(ids)
    if category_column and category_column in t.schema.names:
        cats = t.column(category_column).to_numpy(zero_copy_only=False)
        order = np.lexsort((ids, cats))
    _write_tree(t, ids[order], branching, output_dir)


def cluster_tree(item_input_path: str, output_dir: str, branching: int = 2,
                 embedding_column: str = "embedding") -> None:
    """The items ordered by recursive k-means over their embeddings
    (``branching`` centres, 10 rounds, seeded by the subset's size) under
    a balanced tree."""
    t = pq.read_table(item_input_path)
    ids = t.column(0).to_numpy(zero_copy_only=False).astype(np.int64)
    emb = np.stack(
        t.column(embedding_column).to_numpy(zero_copy_only=False)
    ).astype(np.float32)

    def _recurse(index: np.ndarray) -> List[int]:
        if len(index) <= branching:
            return list(index)
        x = emb[index]
        rng = np.random.default_rng(len(index))
        c = x[rng.choice(len(x), branching, replace=False)].copy()
        for _ in range(10):
            d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
            a = d.argmin(1)
            for j in range(branching):
                if (a == j).any():
                    c[j] = x[a == j].mean(0)
        out: List[int] = []
        for j in range(branching):
            sub = index[a == j]
            if len(sub):
                out.extend(_recurse(sub))
        return out

    order = np.asarray(_recurse(np.arange(len(ids))))
    _write_tree(t, ids[order], branching, output_dir)


def _write_tree(t: pa.Table, ordered_ids: np.ndarray, branching: int,
                output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    root, edges = _build_from_order(ordered_ids, branching,
                                    int(ordered_ids.max()) + 1)
    attrs_by_id = {}
    if len(t.schema.names) > 2:
        raw_ids = t.column(0).to_numpy(zero_copy_only=False)
        raw_attrs = t.column(2).cast(pa.string()).to_pylist()
        attrs_by_id = {int(i): a for i, a in zip(raw_ids, raw_attrs)}
    all_nodes = sorted({n for e in edges for n in e}
                       | set(int(i) for i in ordered_ids))
    pq.write_table(pa.table({
        "id": pa.array(np.asarray(all_nodes, np.int64)),
        "weight": pa.array(np.ones(len(all_nodes))),
        "attrs": pa.array([attrs_by_id.get(n, str(n)) for n in all_nodes]),
    }), os.path.join(output_dir, "node_table.parquet"))
    pq.write_table(pa.table({
        "parent": pa.array(np.asarray([e[0] for e in edges], np.int64)),
        "child": pa.array(np.asarray([e[1] for e in edges], np.int64)),
        "weight": pa.array(np.ones(len(edges))),
    }), os.path.join(output_dir, "edge_table.parquet"))
    with open(os.path.join(output_dir, "root_id.txt"), "w") as f:
        f.write(str(root))


def beam_search_retrieval(score_fn: Callable[[np.ndarray], np.ndarray],
                          children: Dict[int, List[int]], root_id: int,
                          beam: int = 20, max_depth: int = 30) -> List[int]:
    """Layer-wise beam search for one query: the beam's children scored
    by ``score_fn`` (node ids -> scores), the best ``beam`` kept, until
    no node has children; returns the last beam's node ids."""
    frontier = [root_id]
    for _ in range(max_depth):
        cand: List[int] = []
        for n in frontier:
            cand.extend(children.get(n, []))
        if not cand:
            break
        scores = score_fn(np.asarray(cand, np.int64))
        order = np.argsort(-np.asarray(scores))[:beam]
        frontier = [cand[i] for i in order]
    return frontier


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--item_input_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--mode", choices=["init", "cluster"],
                        default="init")
    parser.add_argument("--branching", type=int, default=2)
    parser.add_argument("--category_column", default=None)
    parser.add_argument("--embedding_column", default="embedding")
    args = parser.parse_args(argv)
    if args.mode == "cluster":
        cluster_tree(args.item_input_path, args.output_dir, args.branching,
                     args.embedding_column)
    else:
        init_tree(args.item_input_path, args.output_dir, args.branching,
                  args.category_column)
    print(f"tree written to {args.output_dir}")


if __name__ == "__main__":
    main()

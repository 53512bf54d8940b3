"""TDM retrieval: a layer-wise beam search over the tree, and recall.

Counterpart of torcheasyrec_tpu/tools/tdm/retrieval.py. A trained TDM
model scores (user, node) pairs. For each user the search starts with
every node of layer ceil(log_n(2 * n_cluster * recall_num)) (n the
cluster count), keeps the 2 * recall_num best, expands their children
(``TDMPredictSampler``, ``n_cluster`` each), and at the leaf layer takes
the ``recall_num`` best distinct item ids. Recall is the share of users
whose ground-truth item id (the input's ``item_id_field``) is among
them. Each layer scores a fixed-width [B, W] candidate matrix (pad id -1
scores -inf).

python -m torcheasyrec_tpu_torch.tools.tdm.retrieval \
  --pipeline_config_path cfg --predict_input_path users.parquet \
  [--predict_output_path out.parquet] [--recall_num 200] [--n_cluster 2] \
  [--checkpoint_path ckpt.pt] [--device cpu]
"""

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa


def tdm_retrieval(
    pipeline_config_path: str,
    predict_input_path: str,
    predict_output_path: Optional[str] = None,
    recall_num: int = 200,
    n_cluster: int = 2,
    checkpoint_path: Optional[str] = None,
    batch_size: Optional[int] = None,
    reserved_columns: Optional[str] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Beam-search retrieval for the users of ``predict_input_path`` (a
    parquet file), ``batch_size`` users at a time (else the config's),
    with the weights of ``checkpoint_path`` (else the latest of
    ``model_dir``, else the seeded init) on ``device``. Writes the
    ``reserved_columns`` and ``recall_ids`` (list<int64>) to
    ``predict_output_path`` where given. Returns ``recall`` and ``total``
    (users), and the time it took: ``layer_s`` (seconds per beam layer,
    from the first), ``host_s`` (building and parsing the candidates'
    Arrow columns) and ``device_s`` (the copy, the forward and the copy
    back)."""
    import pyarrow.parquet as pq
    import torch

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.datasets.dataset import create_writer
    from torcheasyrec_tpu_torch.datasets.sampler import (
        TDMPredictSampler,
        TDMSampler,
    )
    from torcheasyrec_tpu_torch.datasets.utils import pa_from_numpy
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    dev = port_main.resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    data_config = pipeline_config.data_config
    bs = batch_size or int(data_config.batch_size)
    model, features = port_main.build_model(pipeline_config, dev)
    ckpt = checkpoint_path or checkpoint_util.latest_checkpoint(
        pipeline_config.model_dir)
    if ckpt:
        checkpoint_util.load_model_weights(ckpt, model)

    sampler_config = data_config.tdm_sampler
    sampler = TDMSampler(sampler_config, is_training=False)
    sampler.init()
    max_level = sampler._max_depth
    expand = TDMPredictSampler(sampler_config, is_training=False)
    expand.init_sampler(n_cluster)
    item_id_field = sampler_config.item_id_field
    attr_fields = set(sampler_config.attr_fields)
    first_layer = min(max_level, int(math.ceil(
        math.log(2 * n_cluster * recall_num, max(n_cluster, 2)))))
    init_nodes = np.sort(sampler._layer_nodes[first_layer])

    parser = DataParser(features, labels=[])
    eval_step = port_main.make_eval_step(model, with_loss=False)
    timing = {"host_s": 0.0, "device_s": 0.0,
              "layer_s": [0.0] * (max_level - first_layer + 1)}

    def _score(user_cols: Dict[str, pa.Array], cand: np.ndarray
               ) -> np.ndarray:
        """cand [B, W] node ids (-1 pad) -> probabilities [B, W]."""
        t0 = time.perf_counter()
        b, w = cand.shape
        idx = pa_from_numpy(np.repeat(np.arange(b, dtype=np.int64), w))
        data = {name: col.take(idx) for name, col in user_cols.items()}
        data.update(expand.node_attr_columns(cand.reshape(-1)))
        batch = parser.parse_to_batch(data)
        t1 = time.perf_counter()
        probs = eval_step(batch.to(dev))[0]["probs"]
        if probs.dim() == 2:  # a two-class head: class 1's
            probs = probs[:, 1]
        probs = probs.float().cpu().numpy().reshape(b, w)
        timing["host_s"] += t1 - t0
        timing["device_s"] += time.perf_counter() - t1
        return np.where(cand >= 0, probs, -np.inf)

    tbl = pq.read_table(predict_input_path)
    reserved = [c.strip() for c in (reserved_columns or "").split(",")
                if c.strip()]
    user_col_names = [c for c in tbl.schema.names if c not in attr_fields]
    beam = 2 * recall_num
    out_chunks: List[Dict[str, pa.Array]] = []
    total = hits = 0
    for start in range(0, tbl.num_rows, bs):
        sl = tbl.slice(start, bs)
        b = sl.num_rows
        gt = sl.column(item_id_field).to_numpy(
            zero_copy_only=False).astype(np.int64)
        user_cols = {c: sl.column(c).combine_chunks() for c in user_col_names}
        cand = np.broadcast_to(init_nodes, (b, len(init_nodes))).copy()
        for layer in range(first_layer, max_level + 1):
            t0 = time.perf_counter()
            probs = _score(user_cols, cand)
            if layer == max_level:
                picked = np.take_along_axis(
                    cand, np.argsort(-probs, axis=1), axis=1)
                recall_ids = []
                for i in range(b):
                    seen, row = set(), []
                    for nid in picked[i]:
                        if nid >= 0 and nid not in seen:
                            seen.add(int(nid))
                            row.append(int(nid))
                            if len(row) == recall_num:
                                break
                    recall_ids.append(row)
            else:
                k = min(beam, cand.shape[1])
                top = np.argpartition(-probs, k - 1, axis=1)[:, :k]
                kept = np.take_along_axis(cand, top, axis=1)
                cand = expand.get_children_ids(kept.reshape(-1)).reshape(
                    b, k * n_cluster)
            timing["layer_s"][layer - first_layer] += (
                time.perf_counter() - t0)
        hits += sum(int(g) in set(r) for g, r in zip(gt, recall_ids))
        total += b
        chunk = {c: sl.column(c) for c in reserved if c in sl.schema.names}
        chunk["recall_ids"] = pa.array(recall_ids, type=pa.list_(pa.int64()))
        out_chunks.append(chunk)

    if predict_output_path:
        writer = create_writer(
            predict_output_path,
            "CsvWriter" if predict_output_path.endswith(".csv")
            else "ParquetWriter")
        for chunk in out_chunks:
            writer.write(chunk)
        writer.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    recall = hits / max(total, 1)
    port_main.logger.info(
        f"tdm_retrieval: recall@{recall_num} = {recall:.4f} over {total} "
        f"users ({len(sampler._item_ids)} nodes, layers {first_layer}.."
        f"{max_level})")
    return {"recall": recall, "total": float(total),
            "first_layer": first_layer, "max_level": max_level, **timing}


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--pipeline_config_path", required=True)
    p.add_argument("--predict_input_path", required=True)
    p.add_argument("--predict_output_path", default=None)
    p.add_argument("--recall_num", type=int, default=200)
    p.add_argument("--n_cluster", type=int, default=2)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--reserved_columns", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    print(tdm_retrieval(
        a.pipeline_config_path, a.predict_input_path, a.predict_output_path,
        a.recall_num, a.n_cluster, a.checkpoint_path, a.batch_size,
        a.reserved_columns, a.device))


if __name__ == "__main__":
    main()

"""Warm-start ZCH (dynamic-embedding) tables from pretrained vectors.

Counterpart of torcheasyrec_tpu/tools/dynamicemb/create_zch_init_ckpt.py
over this package's checkpoints. Each id is inserted through the real
``parallel/zch.lookup_insert`` (so it lands in the slot a later training
lookup probes) and its vector is written into that slot's row. The
result is a checkpoint ``<save_dir>/model.ckpt-0.pt`` of the freshly
initialised model with those rows and mappings, for
``fine_tune_checkpoint`` or ``--continue_train``.

Input per table: a parquet or CSV file whose first column is the raw
int64 id and whose second the embedding, a ``list<float>`` column or a
``--separator``-joined string.

Example::

    python -m torcheasyrec_tpu_torch.tools.dynamicemb.create_zch_init_ckpt \\
        --pipeline_config_path pipeline.config \\
        --init_embedding_paths '{"item_emb": "item_vectors.parquet"}' \\
        --save_dir model_dir/init_ckpt [--device cpu]
"""

import argparse
import dataclasses
import json
import logging
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger("tzrec_tpu_torch")

CHUNK = 65536


def _read_vectors(path: str, separator: str):
    """(ids int64 [N], vectors float32 [N, D]) from parquet or CSV."""
    import pyarrow as pa

    from torcheasyrec_tpu_torch.datasets.sampler import _read_table

    tbl = _read_table(path)
    ids = tbl.column(0).to_numpy(zero_copy_only=False).astype(np.int64)
    col = tbl.column(1)
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
        flat = col.flatten().to_numpy(zero_copy_only=False)
        vecs = np.asarray(flat, np.float32).reshape(len(ids), -1)
    else:
        rows = col.cast(pa.string()).to_pylist()
        vecs = np.asarray(
            [[float(x) for x in (r or "").split(separator)] for r in rows],
            np.float32)
    return ids, vecs


def insert_verified(state: Dict[str, torch.Tensor], zcfg,
                    ids: np.ndarray):
    """Insert ``ids`` into ``state`` (updated in place), retrying the
    losers of within-batch probe races, then (slots, verified mask): the
    slots whose final key is the id (the read path maps an unmatched id
    to probe 0, hence the key check)."""
    from torcheasyrec_tpu_torch.parallel import zch as zch_mod

    dev = state["keys"].device
    todo = ids
    want = zch_mod.wrap_int32(torch.as_tensor(ids)).numpy()
    for _ in range(5):
        if not len(todo):
            break
        for start in range(0, len(todo), CHUNK):
            _, new = zch_mod.lookup_insert(
                state, zcfg, torch.as_tensor(todo[start:start + CHUNK],
                                             device=dev), 0, True)
            state.update(new)
        sl, _ = zch_mod.lookup_insert(state, zcfg,
                                      torch.as_tensor(ids, device=dev), 0,
                                      False)
        sl = sl.cpu().numpy().astype(np.int64)
        keys = state["keys"].cpu().numpy()
        ok = (sl >= 0) & (keys[np.maximum(sl, 0)] == want)
        todo = ids[~ok]
    return sl, ok


def save_tool_checkpoint(model, pipeline_config, save_dir: str) -> str:
    """A step-0 checkpoint of ``model`` (fresh optimizer states)."""
    from torcheasyrec_tpu_torch import main as tzrec_main
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    tx, _ = tzrec_main._dense_optimizer(model, pipeline_config.train_config)
    state = tzrec_main._init_state(model, tx)
    return checkpoint_util.save_checkpoint(save_dir, model, tx, state)


def create_init_ckpt(pipeline_config_path: str,
                     init_embedding_paths: Dict[str, str], save_dir: str,
                     separator: str = ",", initial_score: float = 1.0,
                     device="cuda") -> Dict[str, int]:
    """Returns {table: ids inserted}."""
    import os

    from torcheasyrec_tpu_torch import main as tzrec_main
    from torcheasyrec_tpu_torch.utils import config_util

    cfg = config_util.load_pipeline_config(pipeline_config_path)
    model, _, _ = tzrec_main._build_model_and_optim(cfg, device)
    eg = model.embedding_group
    if not eg.has_zch:
        raise ValueError("no ZCH features in this config")
    states = eg.zch_states()
    fused = eg.engine_tables()
    inserted: Dict[str, int] = {}
    for key, path in init_embedding_paths.items():
        zcfg = eg._zch_cfgs.get(key)
        if zcfg is None:
            raise ValueError(
                f"{key!r} is not a ZCH table; have {sorted(eg._zch_cfgs)}")
        if key not in eg.engine._specs:
            raise ValueError(f"no embedding table named {key!r}; have "
                             f"{sorted(eg.engine._specs)}")
        ids, vecs = _read_vectors(path, separator)
        weight = eg.engine.extract_table(fused, key).detach().cpu().clone()
        if vecs.shape[1] != weight.shape[1]:
            raise ValueError(f"{key}: embedding dim {vecs.shape[1]} != "
                             f"table dim {weight.shape[1]}")
        if len(ids) > zcfg.size:
            logger.warning(
                f"{key}: {len(ids)} init ids > zch_size {zcfg.size}; later "
                f"ids evict earlier ones")
        # warm-start inserts pass the admission and filter gates
        zcfg_ins = dataclasses.replace(zcfg, admit_threshold=0,
                                       filter_fn=None)
        state = dict(states[key])
        sl, ok = insert_verified(state, zcfg_ins, ids)
        weight[torch.as_tensor(sl[ok])] = torch.as_tensor(
            vecs[ok]).to(weight.dtype)
        eg.engine.write_table(fused, key, weight.to(eg.device))
        if initial_score > 0:
            # pre-counted, so fresh ids do not evict them at once
            state["count"] = torch.where(
                state["keys"] >= 0,
                torch.clamp(state["count"], min=initial_score),
                state["count"])
        with torch.no_grad():
            for k, v in state.items():
                states[key][k].copy_(v)
        inserted[key] = int(ok.sum())
        logger.info(f"{key}: inserted {inserted[key]} pretrained vectors")
    os.makedirs(save_dir, exist_ok=True)
    path = save_tool_checkpoint(model, cfg, save_dir)
    logger.info(f"saved warm-start checkpoint to {path}")
    return inserted


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", required=True)
    parser.add_argument("--init_embedding_paths", required=True,
                        help='JSON {"<zch table>": "<id,embedding file>"}')
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--separator", default=",")
    parser.add_argument("--initial_score", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    create_init_ckpt(args.pipeline_config_path,
                     json.loads(args.init_embedding_paths), args.save_dir,
                     args.separator, args.initial_score, args.device)


if __name__ == "__main__":
    main()

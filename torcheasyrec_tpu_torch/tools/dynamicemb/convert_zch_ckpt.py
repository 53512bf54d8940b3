"""Migrate trained ZCH tables across a table-kind or table-size swap.

Counterpart of torcheasyrec_tpu/tools/dynamicemb/convert_zch_ckpt.py
over this package's checkpoints (``model.ckpt-<step>.pt``):

* zch -> zch (resized or re-policied): the trained (key, row, score)
  triples are re-inserted, hottest first, through the new table's real
  ``lookup_insert``, so each surviving id lands in the slot later
  lookups probe; a smaller table drops the coldest ids;
* zch -> static: each trained key's row goes to row ``key % rows``, the
  row an integer raw id takes under ``num_buckets``; of colliding keys
  the hottest keeps the row;
* ``--dump_dir`` writes each ZCH table as an (id, embedding, score)
  parquet, the input of ``create_zch_init_ckpt``.

Dense parameters and non-ZCH tables of matching shapes are copied; a
shape mismatch is skipped with a warning. Optimizer states start fresh.
The converted checkpoint is ``<save_dir>/model.ckpt-0.pt``.

Example::

    python -m torcheasyrec_tpu_torch.tools.dynamicemb.convert_zch_ckpt \\
        --pipeline_config_path old_pipeline.config \\
        --checkpoint_path model_dir/model.ckpt-1000.pt \\
        --new_pipeline_config_path new_pipeline.config \\
        --save_dir model_dir/converted_ckpt [--device cpu]
"""

import argparse
import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from torcheasyrec_tpu_torch.tools.dynamicemb.create_zch_init_ckpt import (
    insert_verified,
    save_tool_checkpoint,
)

logger = logging.getLogger("tzrec_tpu_torch")

_TABLE = "embedding_group.tables."
_ZCH = "embedding_group.zch."


def _extract_zch_rows(zch_state: Dict[str, Any], weight: np.ndarray):
    """(keys [M] int64, rows [M, D], scores [M]) of the occupied slots,
    hottest (largest count) first."""
    keys = np.asarray(zch_state["keys"])
    count = np.asarray(zch_state["count"])
    occ = np.nonzero(keys >= 0)[0]
    order = occ[np.argsort(-count[occ], kind="stable")]
    return (keys[order].astype(np.int64), np.asarray(weight)[order],
            count[order].astype(np.float32))


def _zch_states(model_sd: Dict[str, torch.Tensor]
                ) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in model_sd.items():
        if k.startswith(_ZCH):
            table, name = k[len(_ZCH):].rsplit(".", 1)
            out.setdefault(table, {})[name] = v.cpu().numpy()
    return out


def convert_zch_ckpt(pipeline_config_path: str, checkpoint_path: str,
                     new_pipeline_config_path: Optional[str] = None,
                     save_dir: Optional[str] = None,
                     dump_dir: Optional[str] = None,
                     device="cuda") -> Dict[str, Dict[str, int]]:
    """Returns {table: {"kept": n, "dropped": n}} per converted table."""
    from torcheasyrec_tpu_torch import main as tzrec_main
    from torcheasyrec_tpu_torch.utils import config_util

    old_cfg = config_util.load_pipeline_config(pipeline_config_path)
    old_model, _ = tzrec_main.build_model(old_cfg, device)
    old_zch_cfgs = dict(old_model.embedding_group._zch_cfgs)
    if not old_zch_cfgs:
        raise ValueError("old config has no ZCH tables to convert")
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    old_sd = ckpt.get("model", ckpt)
    old_zch = _zch_states(old_sd)
    old_tables = {k[len(_TABLE):]: v.float().numpy()
                  for k, v in old_sd.items() if k.startswith(_TABLE)}
    report: Dict[str, Dict[str, int]] = {}

    if dump_dir:
        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(dump_dir, exist_ok=True)
        for t in old_zch_cfgs:
            keys, rows, scores = _extract_zch_rows(old_zch[t], old_tables[t])
            pq.write_table(pa.table({
                "id": pa.array(keys),
                "embedding": pa.array(rows.tolist(), pa.list_(pa.float32())),
                "score": pa.array(scores),
            }), os.path.join(dump_dir, f"{t}.parquet"))
            logger.info(f"dumped {len(keys)} rows of {t} to {dump_dir}")
            report.setdefault(t, {"kept": len(keys), "dropped": 0})
    if not save_dir:
        return report

    new_cfg = config_util.load_pipeline_config(new_pipeline_config_path)
    new_model, _, _ = tzrec_main._build_model_and_optim(new_cfg, device)
    eg = new_model.embedding_group
    sd = new_model.state_dict()
    # dense parameters of matching shapes carry over
    for k, v in old_sd.items():
        if (k.startswith(_TABLE) or k.startswith(_ZCH) or k not in sd):
            continue
        if tuple(v.shape) == tuple(sd[k].shape):
            sd[k] = v
        else:
            logger.warning(f"{k}: shape {tuple(v.shape)} -> "
                           f"{tuple(sd[k].shape)}; skipped")
    new_states = eg.zch_states()
    for t, old_w in old_tables.items():
        key = _TABLE + t
        if key not in sd:
            logger.warning(f"table {t} absent in new config; skipped")
            continue
        new_w = sd[key].float().cpu().clone()
        if t not in old_zch_cfgs:
            if tuple(old_w.shape) == tuple(new_w.shape):
                new_w = torch.from_numpy(old_w)
            else:
                logger.warning(f"table {t}: shape {old_w.shape} -> "
                               f"{tuple(new_w.shape)}; skipped")
            sd[key] = new_w
            continue
        keys, rows, scores = _extract_zch_rows(old_zch[t], old_w)
        zcfg = eg._zch_cfgs.get(t)
        if zcfg is not None:
            # these ids earned their slots already: no admission, no filter
            zcfg = dataclasses.replace(zcfg, admit_threshold=0,
                                       filter_fn=None)
            state = {k: v.clone() for k, v in new_states[t].items()}
            sl, ok = insert_verified(state, zcfg, keys)
            new_w[torch.as_tensor(sl[ok])] = torch.as_tensor(rows[ok])
            cnt = state["count"].cpu().numpy().copy()
            cnt[sl[ok]] = np.maximum(cnt[sl[ok]], scores[ok])
            state["count"] = torch.as_tensor(cnt)
            for k, v in state.items():
                sd[f"{_ZCH}{t}.{k}"] = v
            kept = int(ok.sum())
        else:
            slots = keys % new_w.shape[0]
            # hottest first: reversed, so the hottest key writes last
            new_w[torch.as_tensor(slots[::-1].copy())] = torch.as_tensor(
                rows[::-1].copy())
            kept = len(np.unique(slots))
        report[t] = {"kept": kept, "dropped": len(keys) - kept}
        sd[key] = new_w
        logger.info(f"converted {t}: {report[t]}")
    new_model.load_state_dict(sd)
    os.makedirs(save_dir, exist_ok=True)
    path = save_tool_checkpoint(new_model, new_cfg, save_dir)
    logger.info(f"saved converted checkpoint to {path}")
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", required=True)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--new_pipeline_config_path")
    parser.add_argument("--save_dir")
    parser.add_argument("--dump_dir", help="also write each ZCH table as "
                        "(id, embedding, score) parquet")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.save_dir and not args.new_pipeline_config_path:
        parser.error("--save_dir requires --new_pipeline_config_path")
    convert_zch_ckpt(args.pipeline_config_path, args.checkpoint_path,
                     args.new_pipeline_config_path, args.save_dir,
                     args.dump_dir, args.device)


if __name__ == "__main__":
    main()

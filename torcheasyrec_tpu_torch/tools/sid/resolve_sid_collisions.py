"""Offline best-effort SID collision resolution.

Counterpart of torcheasyrec_tpu/tools/sid/resolve_sid_collisions.py
over this package's readers and writers. Input is a Semantic-ID table from ``predict`` over a SID model: an
``item_id`` column, a ``codes`` ``list<int>`` column (one code per
quantizer layer), and — for the default ``candidate`` strategy — a
flat ``candidate_codes`` column holding ``topk * n_layers`` codes per
item (the k nearest last-layer alternatives emitted alongside each
item's SID).

Buckets over ``--max_items_per_codebook`` keep their first-capacity
items (deterministic item-id-hash order) and relocate the rest to the
first free candidate last-layer code within the same band; items with
no free candidate keep their original SID over capacity. Duplicate
item ids stay independent rows (fix duplicates upstream); duplicate
overflow ids share one candidate list.

Outputs (all through the package's readers/writers, parquet or CSV: CSV
encodes code lists comma-separated and item-id groups as JSON arrays
because Arrow's CSV writer cannot serialize list columns):

* ``--output_path``: item-level map — item_id, origin_codebook,
  codebook (resolved), index (1-based slot within the final bucket).
* ``--resolved_sid_groups_output_path``: per-SID grouping of the
  resolved codes.
* ``--original_sid_groups_output_path`` (optional audit): grouping of
  the original codes.

Example::

    python -m torcheasyrec_tpu_torch.tools.sid.resolve_sid_collisions \
        --input_path 'sid_predict_output/*.parquet' \
        --codebook 256,256,256 --max_items_per_codebook 5 \
        --strategy candidate \
        --output_path sid_collision/map \
        --resolved_sid_groups_output_path sid_collision/resolved_groups
"""

import argparse
import json
import logging
import os
from contextlib import closing
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from torcheasyrec_tpu_torch.datasets.csv_dataset import CsvWriter
from torcheasyrec_tpu_torch.datasets.dataset import (
    create_reader,
    create_writer,
)
from torcheasyrec_tpu_torch.utils.sid.collision import (
    CollisionResult,
    group_items,
    resolve_collisions,
)

logger = logging.getLogger("tzrec_tpu_torch")

_BATCH = 65536


def decode_codes(col: pa.Array, width: Optional[int] = None) -> np.ndarray:
    """list<int> / comma-string / fixed-width column -> [N, W] int64."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    t = col.type
    if pa.types.is_list(t) or pa.types.is_large_list(t) or (
        hasattr(pa.types, "is_fixed_size_list")
        and pa.types.is_fixed_size_list(t)
    ):
        lens = np.diff(col.offsets.to_numpy()) if not \
            pa.types.is_fixed_size_list(t) else None
        flat = col.flatten().to_numpy(zero_copy_only=False).astype(np.int64)
        if lens is not None:
            w = int(lens[0]) if lens.size else (width or 0)
            if lens.size and not (lens == w).all():
                raise ValueError(
                    f"ragged codes column: widths {np.unique(lens)[:5]}"
                )
        else:
            w = t.list_size
        return flat.reshape(-1, w)
    # comma-joined string rows
    rows = col.cast(pa.string()).to_pylist()
    mat = [[int(x) for x in (r or "").split(",")] for r in rows]
    w = len(mat[0]) if mat else (width or 0)
    if any(len(m) != w for m in mat):
        raise ValueError("ragged comma-encoded codes column")
    return np.asarray(mat, np.int64).reshape(-1, w)


def _load_codes(input_path: str, item_id_field: str, codes_field: str,
                n_layers: int) -> Tuple[np.ndarray, np.ndarray]:
    ids: List[np.ndarray] = []
    codes: List[np.ndarray] = []
    reader = create_reader(
        input_path, _BATCH, selected_cols=[item_id_field, codes_field]
    )
    for batch in reader.to_batches():
        if codes_field not in batch:
            raise ValueError(
                f"codes field {codes_field!r} missing from input batch; "
                f"have {sorted(batch)}"
            )
        ids.append(np.asarray(
            batch[item_id_field].to_numpy(zero_copy_only=False)
        ))
        m = decode_codes(batch[codes_field])
        if m.shape[1] != n_layers:
            raise ValueError(
                f"codes width {m.shape[1]} != n_layers {n_layers}"
            )
        codes.append(m)
    if not ids:
        raise ValueError(f"no rows read from {input_path}")
    return np.concatenate(ids), np.concatenate(codes)


def _load_candidates(input_path: str, item_id_field: str,
                     candidate_field: str, overflow_ids: np.ndarray,
                     n_layers: int) -> np.ndarray:
    """[M, topk] last-layer candidates aligned to overflow_ids.

    Second streaming scan so candidates are only materialized for
    overflow rows. Duplicate overflow ids share
    the one candidate list found for that id.
    """
    where: Dict[object, List[int]] = {}
    for pos, iid in enumerate(overflow_ids.tolist()):
        where.setdefault(iid, []).append(pos)
    out: Optional[np.ndarray] = None
    seen = np.zeros(len(overflow_ids), bool)
    reader = create_reader(
        input_path, _BATCH, selected_cols=[item_id_field, candidate_field]
    )
    for batch in reader.to_batches():
        if candidate_field not in batch:
            raise ValueError(
                f"candidate field {candidate_field!r} missing from input; "
                "use --strategy random or fix --candidate_codes_field"
            )
        batch_ids = np.asarray(
            batch[item_id_field].to_numpy(zero_copy_only=False)
        )
        hits = [i for i, v in enumerate(batch_ids.tolist()) if v in where]
        if not hits:
            continue
        sel = batch[candidate_field]
        if isinstance(sel, pa.ChunkedArray):
            sel = sel.combine_chunks()
        flat = decode_codes(sel.take(pa.array(hits, pa.int64())))
        if flat.shape[1] % n_layers:
            raise ValueError(
                f"candidate_codes width {flat.shape[1]} is not a multiple "
                f"of n_layers {n_layers}"
            )
        last = flat[:, n_layers - 1 :: n_layers]  # [hits, topk]
        if out is None:
            out = np.empty((len(overflow_ids), last.shape[1]), np.int64)
        elif out.shape[1] != last.shape[1]:
            raise ValueError(
                f"candidate topk changed between batches: {out.shape[1]} "
                f"vs {last.shape[1]}"
            )
        for row, i in enumerate(hits):
            for pos in where[batch_ids[i]]:
                out[pos] = last[row]
                seen[pos] = True
    if out is None or not seen.all():
        missing = int((~seen).sum()) if out is not None else len(
            overflow_ids
        )
        raise ValueError(
            f"candidate_codes missing for {missing} overflow items"
        )
    return out


def _codes_col(codes: np.ndarray, is_csv: bool) -> pa.Array:
    if is_csv:
        return pa.array([",".join(map(str, r)) for r in codes.tolist()])
    return pa.array(codes.tolist(), pa.list_(pa.int64()))


def _ids_col(ids: np.ndarray) -> pa.Array:
    if np.issubdtype(ids.dtype, np.integer):
        return pa.array(ids, pa.int64())
    return pa.array([str(v) for v in ids.tolist()])


def _write_map(path: str, writer_type: str, item_ids, codes,
               result: CollisionResult) -> None:
    final = codes.astype(np.int64, copy=True)
    final[:, -1] = result.resolved_last_codes
    with closing(create_writer(path, writer_type)) as writer:
        is_csv = isinstance(writer, CsvWriter)
        for start in range(0, len(item_ids), _BATCH):
            sl = slice(start, start + _BATCH)
            writer.write({
                "item_id": _ids_col(item_ids[sl]),
                "origin_codebook": _codes_col(codes[sl], is_csv),
                "codebook": _codes_col(final[sl], is_csv),
                "index": pa.array(result.slot_indices[sl], pa.int64()),
            })
    logger.info(f"wrote resolved item map to {path}")


def _write_groups(path: str, writer_type: str, item_ids, codes,
                  layer_sizes, resolved_last=None) -> None:
    sid_codes, offsets, row_order = group_items(
        item_ids, codes, layer_sizes, resolved_last
    )
    with closing(create_writer(path, writer_type)) as writer:
        is_csv = isinstance(writer, CsvWriter)
        for start in range(0, len(sid_codes), _BATCH):
            end = min(start + _BATCH, len(sid_codes))
            groups = [
                item_ids[row_order[offsets[i] : offsets[i + 1]]].tolist()
                for i in range(start, end)
            ]
            if is_csv:
                gcol = pa.array([json.dumps(g, default=str) for g in groups])
            else:
                if np.issubdtype(item_ids.dtype, np.integer):
                    gcol = pa.array(groups, pa.list_(pa.int64()))
                else:
                    gcol = pa.array(
                        [[str(v) for v in g] for g in groups],
                        pa.list_(pa.string()),
                    )
            writer.write({
                "codebook": _codes_col(sid_codes[start:end], is_csv),
                "item_ids": gcol,
                "count": pa.array(
                    np.diff(offsets)[start:end], pa.int64()
                ),
            })
    logger.info(f"wrote SID groups to {path}")


def run(args: argparse.Namespace) -> CollisionResult:
    layer_sizes = [int(s) for s in args.codebook.split(",")]
    writer_type = args.writer_type or (
        "CsvWriter" if ".csv" in args.input_path else "ParquetWriter"
    )
    item_ids, codes = _load_codes(
        args.input_path, args.item_id_field, args.codes_field,
        len(layer_sizes),
    )
    logger.info(f"loaded {len(item_ids)} items")

    # plan first with no candidates to learn the overflow set, then
    # load candidates only for those rows
    cands = None
    nrand = None
    if args.strategy == "random":
        nrand = args.num_random_candidates
    else:
        probe = resolve_collisions(
            item_ids, codes, layer_sizes, args.max_items_per_codebook,
            num_random_candidates=1,
        )
        if probe.overflow_rows.size:
            last = _load_candidates(
                args.input_path, args.item_id_field,
                args.candidate_codes_field,
                item_ids[probe.overflow_rows], len(layer_sizes),
            )
            cands = np.zeros((len(item_ids), last.shape[1]), np.int64)
            cands[probe.overflow_rows] = last
        else:
            nrand = 1  # no overflow; strategy is moot

    result = resolve_collisions(
        item_ids, codes, layer_sizes, args.max_items_per_codebook,
        candidate_last_codes=cands, num_random_candidates=nrand,
    )
    logger.info(f"collision resolution stats: {result.stats}")

    if args.output_path:
        _write_map(args.output_path, writer_type, item_ids, codes, result)
    if args.original_sid_groups_output_path:
        _write_groups(
            args.original_sid_groups_output_path, writer_type,
            item_ids, codes, layer_sizes,
        )
    if args.resolved_sid_groups_output_path:
        _write_groups(
            args.resolved_sid_groups_output_path, writer_type,
            item_ids, codes, layer_sizes, result.resolved_last_codes,
        )
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_path", required=True)
    p.add_argument("--item_id_field", default="item_id")
    p.add_argument("--codes_field", default="codes")
    p.add_argument("--candidate_codes_field", default="candidate_codes")
    p.add_argument("--codebook", required=True,
                   help="comma-separated per-layer sizes, e.g. 256,256,256")
    p.add_argument("--max_items_per_codebook", type=int, required=True)
    p.add_argument("--strategy", choices=["candidate", "random"],
                   default="candidate")
    p.add_argument("--num_random_candidates", type=int, default=32)
    p.add_argument("--output_path")
    p.add_argument("--resolved_sid_groups_output_path")
    p.add_argument("--original_sid_groups_output_path")
    p.add_argument("--writer_type",
                   choices=["ParquetWriter", "CsvWriter"])
    return p


if __name__ == "__main__":
    ns = build_parser().parse_args()
    if not (ns.output_path or ns.resolved_sid_groups_output_path):
        build_parser().error(
            "need --output_path and/or --resolved_sid_groups_output_path"
        )
    for out in (ns.output_path, ns.resolved_sid_groups_output_path,
                ns.original_sid_groups_output_path):
        if out and os.path.abspath(out) == os.path.abspath(ns.input_path):
            build_parser().error(f"output {out} would overwrite the input")
    run(ns)

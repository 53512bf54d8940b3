"""Evaluate exact global semantic-ID collision and distribution quality.

Counterpart of torcheasyrec_tpu/tools/sid/evaluate_sid_quality.py over
this package's readers and writers. Evaluates one explicitly selected SID field, or compares an original
field with a final field from the same item-aligned input rows
(comparison restricts both sides to the common valid-row cohort and
reports ``before``, ``after``, and ``delta = after - before`` views).

Example::

    python -m torcheasyrec_tpu_torch.tools.sid.evaluate_sid_quality \
        --input_path 'predict_output/*.parquet' \
        --codes_field codes --codebook 256,256,256 \
        --summary_output out/summary --layer_stats_output out/layer_stats
"""

import argparse
import dataclasses
import logging
from contextlib import closing
from typing import List, Optional

import pyarrow as pa

from torcheasyrec_tpu_torch.datasets.dataset import (
    create_reader,
    create_writer,
)
from torcheasyrec_tpu_torch.tools.sid.resolve_sid_collisions import (
    decode_codes,
)
from torcheasyrec_tpu_torch.utils.sid.quality import (
    SidQualityAccumulator,
    SidQualityResult,
    compare_sid_quality,
    valid_code_rows,
)

logger = logging.getLogger("tzrec_tpu_torch")

_BATCH = 65536


def evaluate(
    input_path: str,
    codebook: List[int],
    codes_field: str = "codes",
    original_codes_field: Optional[str] = None,
    top_sids: Optional[int] = None,
):
    """Returns {"after": SidQualityResult} plus, when comparing,
    "before" and "delta" over the common valid cohort."""
    fields = [codes_field]
    if original_codes_field:
        fields.append(original_codes_field)
    acc = SidQualityAccumulator(codebook, top_sids=top_sids)
    acc_before = (
        SidQualityAccumulator(codebook, top_sids=top_sids)
        if original_codes_field else None
    )
    skipped = 0
    reader = create_reader(input_path, _BATCH, selected_cols=fields)
    for batch in reader.to_batches():
        for f in fields:
            if f not in batch:
                raise ValueError(
                    f"field {f!r} missing from input; have {sorted(batch)}"
                )
        after = decode_codes(batch[codes_field], width=len(codebook))
        ok = valid_code_rows(after, codebook)
        if acc_before is not None:
            before = decode_codes(
                batch[original_codes_field], width=len(codebook)
            )
            # common valid-row cohort: before/after must describe the
            # same items for the delta to be meaningful
            ok = ok & valid_code_rows(before, codebook)
            acc_before.update(before[ok])
        acc.update(after[ok])
        skipped += int((~ok).sum())
    if skipped:
        logger.warning(f"skipped {skipped} rows with out-of-range codes")
    out = {"after": acc.finalize()}
    if acc_before is not None:
        out["before"] = acc_before.finalize()
        out["delta"] = compare_sid_quality(out["before"], out["after"])
    return out


def _write_outputs(results, summary_output: Optional[str],
                   layer_stats_output: Optional[str],
                   writer_type: str) -> None:
    order = [v for v in ("before", "after", "delta") if v in results]
    if summary_output:
        with closing(create_writer(summary_output, writer_type)) as w:
            cols = {"view": pa.array(order)}
            for f in dataclasses.fields(results["after"].metrics):
                cols[f.name] = pa.array(
                    [float(getattr(results[v].metrics, f.name))
                     for v in order],
                    pa.float64(),
                )
            w.write(cols)
        logger.info(f"wrote summary to {summary_output}")
    if layer_stats_output:
        with closing(create_writer(layer_stats_output, writer_type)) as w:
            rows = [
                (v, lm) for v in order for lm in results[v].layer_metrics
            ]
            cols = {"view": pa.array([v for v, _ in rows])}
            for f in dataclasses.fields(rows[0][1]):
                cols[f.name] = pa.array(
                    [float(getattr(lm, f.name)) for _, lm in rows],
                    pa.float64(),
                )
            w.write(cols)
        logger.info(f"wrote layer stats to {layer_stats_output}")


def _log(name: str, res: SidQualityResult) -> None:
    logger.info(f"[{name}] {res.metrics}")
    for lm in res.layer_metrics:
        logger.info(f"[{name}] {lm}")
    if res.top_sids:
        for sid, cnt in res.top_sids:
            logger.info(f"[{name}] top sid {sid}: {cnt}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_path", required=True)
    p.add_argument("--codes_field", default="codes")
    p.add_argument("--original_codes_field",
                   help="compare: before-field over the same rows")
    p.add_argument("--codebook", required=True,
                   help="comma-separated per-layer sizes")
    p.add_argument("--summary_output")
    p.add_argument("--layer_stats_output")
    p.add_argument("--top_sids", type=int)
    p.add_argument("--writer_type",
                   choices=["ParquetWriter", "CsvWriter"],
                   default="ParquetWriter")
    args = p.parse_args()
    results = evaluate(
        args.input_path,
        [int(s) for s in args.codebook.split(",")],
        args.codes_field,
        args.original_codes_field,
        args.top_sids,
    )
    for view, res in results.items():
        _log(view, res)
    _write_outputs(
        results, args.summary_output, args.layer_stats_output,
        args.writer_type,
    )


if __name__ == "__main__":
    main()

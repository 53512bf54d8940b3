"""Annotate a pipeline config with feature statistics from its data.

Counterpart of torcheasyrec_tpu/tools/add_feature_info_to_config.py:
reads the first ``sample_rows`` rows of the config's
``train_input_path`` (parquet) and fills in what a feature lacks: an id
feature without ``num_buckets``, ``hash_bucket_size`` or a vocab gets
``num_buckets`` from its largest id (``hash_bucket_size`` from its
distinct values where they are not numbers), a raw feature without
``boundaries`` gets ``num_boundaries`` quantiles. The config is written
to ``output_path``.

    python -m torcheasyrec_tpu_torch.tools.add_feature_info_to_config \\
        --pipeline_config_path pipeline.config --output_path out.config \\
        [--sample_rows 200000] [--num_boundaries 0]
"""

import argparse

import numpy as np
import pyarrow.parquet as pq

from torcheasyrec_tpu_torch.utils import config_util


def add_feature_info(
    pipeline_config_path: str,
    output_path: str,
    sample_rows: int = 200_000,
    num_boundaries: int = 0,
) -> None:
    cfg = config_util.load_pipeline_config(pipeline_config_path)
    tbl = pq.read_table(cfg.train_input_path).slice(0, sample_rows)
    names = set(tbl.schema.names)
    for fc in cfg.feature_configs:
        oneof = fc.WhichOneof("feature")
        inner = getattr(fc, oneof)
        name = getattr(inner, "feature_name", "")
        if name not in names:
            continue
        col = tbl.column(name)
        if oneof == "id_feature" and not (
            inner.num_buckets or inner.hash_bucket_size
            or len(inner.vocab_list)
        ):
            vals = col.to_numpy(zero_copy_only=False)
            try:
                inner.num_buckets = int(np.nanmax(
                    vals.astype(np.float64))) + 1
            except (ValueError, TypeError):
                inner.hash_bucket_size = max(
                    int(len(np.unique(vals)) * 1.5), 16)
        elif oneof == "raw_feature" and num_boundaries > 0 and not len(
            inner.boundaries
        ):
            vals = col.to_numpy(zero_copy_only=False).astype(np.float64)
            qs = np.quantile(
                vals[np.isfinite(vals)],
                np.linspace(0, 1, num_boundaries + 2)[1:-1],
            )
            del inner.boundaries[:]
            inner.boundaries.extend(float(q) for q in np.unique(qs))
    config_util.save_message(cfg, output_path)
    print(f"wrote {output_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--sample_rows", type=int, default=200000)
    parser.add_argument("--num_boundaries", type=int, default=0)
    args = parser.parse_args()
    add_feature_info(args.pipeline_config_path, args.output_path,
                     args.sample_rows, args.num_boundaries)

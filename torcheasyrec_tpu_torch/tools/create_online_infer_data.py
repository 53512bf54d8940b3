"""Sample raw rows into a serving-request fixture.

Counterpart of torcheasyrec_tpu/tools/create_online_infer_data.py: the
first ``num_rows`` rows of the config's (raw, pre-FG) train input, as
JSON lines of the feature input columns it has, for the smoke tests of
an online service.

python -m torcheasyrec_tpu_torch.tools.create_online_infer_data \
  --pipeline_config_path <cfg> --output_path rows.jsonl [--num_rows 16]
"""

import argparse
import json

import pyarrow.parquet as pq

from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.utils import config_util


def create_online_data(pipeline_config_path: str, output_path: str,
                       num_rows: int = 16) -> int:
    """Write the rows; returns how many."""
    cfg = config_util.load_pipeline_config(pipeline_config_path)
    features = create_features(list(cfg.feature_configs),
                               fg_mode=cfg.data_config.fg_mode)
    cols = []
    for f in features:
        cols.extend(c for c in f.inputs if c not in cols)
    tbl = pq.read_table(cfg.train_input_path).slice(0, num_rows)
    rows = tbl.select([c for c in cols if c in tbl.schema.names]).to_pylist()
    with open(output_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, default=str) + "\n")
    return len(rows)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--num_rows", type=int, default=16)
    args = parser.parse_args()
    n = create_online_data(args.pipeline_config_path, args.output_path,
                           args.num_rows)
    print(f"wrote {n} rows to {args.output_path}")

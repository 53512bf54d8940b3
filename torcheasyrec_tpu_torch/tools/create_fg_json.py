"""Write the serving-side ``fg.json`` of a pipeline config.

Counterpart of torcheasyrec_tpu/tools/create_fg_json.py: the features of
the config (in its ``fg_mode``), as ``features.create_fg_json`` writes
them, which is also the ``fg.json`` ``main.export`` puts beside an
artifact.

python -m torcheasyrec_tpu_torch.tools.create_fg_json \
  --pipeline_config_path <cfg> --fg_output_dir <dir>
"""

import argparse
import json
import os

from torcheasyrec_tpu_torch.features import create_features, create_fg_json
from torcheasyrec_tpu_torch.utils import config_util


def write_fg_json(pipeline_config_path: str, fg_output_dir: str) -> str:
    """Write ``<fg_output_dir>/fg.json``; returns its path."""
    cfg = config_util.load_pipeline_config(pipeline_config_path)
    features = create_features(list(cfg.feature_configs),
                               fg_mode=cfg.data_config.fg_mode)
    os.makedirs(fg_output_dir, exist_ok=True)
    out = os.path.join(fg_output_dir, "fg.json")
    with open(out, "w") as f:
        json.dump(create_fg_json(features), f, indent=2)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", required=True)
    parser.add_argument("--fg_output_dir", required=True)
    args = parser.parse_args()
    print(f"wrote {write_fg_json(args.pipeline_config_path, args.fg_output_dir)}")

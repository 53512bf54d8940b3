"""Feature selection by variational dropout.

Counterpart of torcheasyrec_tpu/tools/feature_selection.py: reads the
trained drop probabilities of every group's ``VariationalDropout`` from a
checkpoint of this package (the latest in ``model_dir`` unless one is
named), ranks the features by keep probability (1 - p; per feature the
mean over its lanes with ``embedding_wise``; a feature in several groups
keeps its best), and with ``output_dir`` writes the ranking to
``feature_importance.json`` and the pipeline config cut to the top k
features to ``pipeline.config``. Without variational dropout in the
config it ranks the sparse features by their table's norm over its row
count, the tables read through ``extract_table``.

    python -m torcheasyrec_tpu_torch.tools.feature_selection \\
        --pipeline_config_path <cfg> [--checkpoint_path ckpt.pt] \\
        [--topk 100] [--output_dir dir] [--device cpu]
"""

import argparse
import json
import os
from typing import Dict, Optional

import torch


def select_features(pipeline_config_path: str,
                    checkpoint_path: Optional[str] = None, topk: int = 100,
                    output_dir: Optional[str] = None,
                    device="cuda") -> Dict[str, float]:
    """{feature name: keep probability (or table norm)} of the top
    ``topk`` features, best first."""
    from torcheasyrec_tpu_torch.main import build_model
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    cfg = config_util.load_pipeline_config(pipeline_config_path)
    model, features = build_model(cfg, device)
    ckpt = checkpoint_path or checkpoint_util.latest_checkpoint(
        cfg.model_dir)
    if ckpt:
        checkpoint_util.load_model_weights(ckpt, model)

    importances: Dict[str, float] = {}
    if not model.variational_dropout:
        eg = model.embedding_group
        tables = eg.engine_tables()
        for feat in features:
            if feat.is_sparse:
                w = eg.engine.extract_table(tables, feat.emb_config().name)
                importances[feat.name] = float(
                    torch.linalg.vector_norm(w.float()) / max(w.shape[0], 1))
    else:
        for g, vd in model.variational_dropout.items():
            keep = (1.0 - vd.drop_probabilities()).cpu()
            if vd.embedding_wise:
                keep = torch.stack([part.mean() for part in
                                    keep.split(vd.feature_dims)])
            for name, k in zip(model.vd_feature_names[g], keep.tolist()):
                importances[name] = max(k, importances.get(name, 0.0))

    ranked = dict(sorted(importances.items(), key=lambda kv: -kv[1])[:topk])
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "feature_importance.json"),
                  "w") as f:
            json.dump(ranked, f, indent=2)
        _rewrite_config(cfg, set(ranked), output_dir)
    return ranked


def _rewrite_config(cfg, keep_names, output_dir: str) -> None:
    """The config with only the kept features (sequence features stay) in
    its feature configs and groups, as ``<output_dir>/pipeline.config``."""
    from google.protobuf import text_format

    new_cfg = type(cfg)()
    new_cfg.CopyFrom(cfg)
    del new_cfg.feature_configs[:]
    for fc in cfg.feature_configs:
        oneof = fc.WhichOneof("feature")
        inner = getattr(fc, oneof)
        name = (getattr(inner, "feature_name", None)
                or getattr(inner, "sequence_name", ""))
        if name in keep_names or oneof == "sequence_feature":
            new_cfg.feature_configs.append(fc)
    for g in new_cfg.model_config.feature_groups:
        kept = [n for n in g.feature_names if n in keep_names]
        del g.feature_names[:]
        g.feature_names.extend(kept)
    with open(os.path.join(output_dir, "pipeline.config"), "w") as f:
        f.write(text_format.MessageToString(new_cfg, as_utf8=True))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", required=True)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    print(json.dumps(select_features(
        args.pipeline_config_path, args.checkpoint_path, args.topk,
        args.output_dir, args.device), indent=2))

"""Mock data driven by feature configs.

Counterpart of torcheasyrec_tpu/utils/test_util.py, value for value: a
table of fg-encoded columns whose label is a noisy function of the
features, so a trained model's AUC moves. ``main.export`` traces its
serving program over such a table.
"""

import os
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from torcheasyrec_tpu_torch.features.feature import BaseFeature


def generate_mock_table(
    features: List[BaseFeature],
    num_rows: int,
    label_fields: Optional[List[str]] = None,
    seed: int = 0,
    extra_columns: Optional[Dict[str, np.ndarray]] = None,
) -> pa.Table:
    """Synthesize an fg-encoded table for the given features.

    The label is sigmoid(sum of per-feature latent scores) > u, making
    it learnable."""
    rng = np.random.default_rng(seed)
    cols: Dict[str, Any] = {}
    score = np.zeros(num_rows, np.float64)
    for feat in features:
        col_name = feat.inputs[0]
        # latent label weights fixed per feature name, so train and eval
        # tables share one ground-truth function whatever the seed
        latent_rng = np.random.default_rng(
            zlib.crc32(f"latent:{feat.name}".encode())
        )
        if feat.is_sequence:
            max_len = feat.effective_sequence_length or 10
            # honor the feature's configured step delimiter (grouped
            # sequence_feature configs often use '|', not ';')
            delim = feat.effective_sequence_delim
            # sub-features of one grouped sequence must share step
            # counts (the group's lengths come from the first one)
            len_rng = np.random.default_rng(
                zlib.crc32(
                    f"len:{feat.sequence_name or feat.name}:{seed}".encode()
                )
            )
            lengths = len_rng.integers(1, max_len + 1, num_rows)
            if feat.is_sparse:
                n = int(feat.num_embeddings)
                vals = [
                    delim.join(
                        str(v)
                        for v in rng.integers(0, n, size=lengths[i])
                    )
                    for i in range(num_rows)
                ]
                cols[col_name] = pa.array(vals)
            else:
                vals = [
                    delim.join(
                        f"{rng.normal():.4f}" for _ in range(lengths[i])
                    )
                    for i in range(num_rows)
                ]
                cols[col_name] = pa.array(vals)
        elif feat.is_sparse:
            n = int(feat.num_embeddings)
            ids = rng.integers(0, n, num_rows)
            latent = latent_rng.normal(0, 1.0, size=min(n, 10 ** 6))
            score += latent[ids % len(latent)] / np.sqrt(
                max(len([f for f in features if f.is_sparse]), 1)
            )
            cols[col_name] = pa.array(ids.astype(np.int64))
        else:
            dim = max(feat.value_dim, 1)
            v = rng.normal(0, 1.0, size=(num_rows, dim))
            w0 = latent_rng.normal(0, 1.0)
            score += v[:, 0] * 0.3 * w0
            if dim == 1:
                cols[col_name] = pa.array(v[:, 0].astype(np.float32))
            else:
                sep = chr(3)
                cols[col_name] = pa.array(
                    [sep.join(f"{x:.4f}" for x in row) for row in v]
                )
    prob = 1.0 / (1.0 + np.exp(-(score - score.mean())))
    for label in label_fields or []:
        labels = (rng.random(num_rows) < prob).astype(np.float32)
        cols[label] = pa.array(labels)
    for name, arr in (extra_columns or {}).items():
        cols[name] = pa.array(arr)
    return pa.table(cols)


def write_mock_parquet(
    path: str,
    features: List[BaseFeature],
    num_rows: int,
    label_fields: Optional[List[str]] = None,
    seed: int = 0,
    extra_columns: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tbl = generate_mock_table(
        features, num_rows, label_fields, seed, extra_columns
    )
    pq.write_table(tbl, path)
    return path

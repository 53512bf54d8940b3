"""List every tensor of a checkpoint with its path, shape and dtype.

Counterpart of torcheasyrec_tpu/tools/list_ckpt_param.py, for the
port's checkpoints (``model.ckpt-<step>.pt``, ``utils/checkpoint_util``):
the model's ``state_dict`` (``model/...``: dense parameters, canonical
tables, ZCH mappings), the sparse optimizer state per table
(``sparse_opt/<table>/<name>``), the dense optimizer state, the
accumulated gradients and the grad scaler where present, and the spill
stores (``zch_spill/<table>/...``). Useful to author a
``fine_tune_ckpt_param_map``. A directory lists its latest checkpoint;
an export artifact's ``model/model.pt`` lists the same way. The file is
memory-mapped: no tensor is read.

    python -m torcheasyrec_tpu_torch.tools.list_ckpt_param \\
        --checkpoint_path model_dir/model.ckpt-100.pt
"""

import argparse
import os
from typing import Any, List, Tuple

import numpy as np
import torch

from torcheasyrec_tpu_torch.utils import checkpoint_util


def list_params(checkpoint_path: str) -> List[Tuple[str, tuple, str]]:
    """[(path, shape, dtype)] of every tensor (and numpy array) in the
    checkpoint, in the file's order; a path joins the dict keys and list
    indices with ``/``."""
    path = checkpoint_path
    if os.path.isdir(path):
        path = checkpoint_util.latest_checkpoint(path) or os.path.join(
            path, checkpoint_util.MODEL_FILE)
    raw = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    out: List[Tuple[str, tuple, str]] = []

    def _walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                _walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                _walk(v, f"{prefix}/{i}" if prefix else str(i))
        elif isinstance(node, torch.Tensor):
            out.append((prefix, tuple(node.shape),
                        str(node.dtype).replace("torch.", "")))
        elif isinstance(node, np.ndarray):
            out.append((prefix, tuple(node.shape), str(node.dtype)))

    _walk(raw, "")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", required=True)
    args = parser.parse_args()
    for p, shape, dtype in list_params(args.checkpoint_path):
        print(f"{p}\t{shape}\t{dtype}")

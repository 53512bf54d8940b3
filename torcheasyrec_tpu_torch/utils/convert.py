"""Carry weights across from the JAX package.

``from_jax_state(dense_params, tables)`` maps the JAX model's parameters
(numpy arrays, e.g. after ``jax.device_get``) onto this package's
``state_dict`` names:

- pytree paths join with "."; ``layer_<i>`` becomes ``layers.<i>``;
- linear ``kernel`` [in, out] becomes ``weight`` [out, in], LayerNorm
  ``scale`` becomes ``weight``;
- the STU's ``uvqk_w`` [E, F] and ``output_w`` [H*ld, E] become
  ``uvqk_weight`` [F, E] and ``output_weight`` [E, H*ld], ``uvqk_b``
  becomes ``uvqk_bias``;
- ``tables`` ({table name: [rows, dim]}, canonical layout) become
  ``embedding_group.tables.<name>``.

This module never imports JAX.
"""

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_TRANSPOSED = {"kernel": "weight", "uvqk_w": "uvqk_weight",
               "output_w": "output_weight"}
_RENAMED = {"scale": "weight", "uvqk_b": "uvqk_bias"}


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def from_jax_state(dense_params: Mapping[str, Any],
                   tables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX dense params + canonical tables -> a torch state_dict (fp32)."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(dense_params):
        if path.startswith("embedding_group."):
            raise NotImplementedError(
                f"{path}: sequence encoders and dense embeddings are not "
                "ported"
            )
        parts = re.sub(r"(^|\.)layer_(\d+)(?=\.)", r"\1layers.\2",
                       path).split(".")
        leaf = parts[-1]
        val = np.array(arr, dtype=np.float32)
        if leaf in _TRANSPOSED:
            parts[-1] = _TRANSPOSED[leaf]
            val = val.T
        else:
            parts[-1] = _RENAMED.get(leaf, leaf)
        state[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(val))
    for name, arr in tables.items():
        state[f"embedding_group.tables.{name}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32)
        )
    return state

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

The optimizer state crosses too, so the two packages can be held
together after step k and not only at step 0:
``sparse_opt_state_from_jax`` takes each table's state as the JAX
engine's ``extract_table_state`` gives it and lays it into this
package's per-group state; ``dense_opt_state_from_jax`` takes optax
adam's ``mu``, ``nu`` and ``count`` and gives a ``DenseOptimizer``
state dict.

This module never imports JAX.
"""

import re
from typing import Any, Dict, Mapping, Sequence

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


def sparse_opt_state_from_jax(
    engine, table_states: Mapping[str, Mapping[str, Any]], device=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """{table name: {state name: array}} (row state [rows, width] and
    scalars, as ``extract_table_state`` returns them) -> the engine's
    per-group sparse optimizer state."""
    state = engine.init_opt_state(device)
    for name, st in table_states.items():
        gk, off, rows = engine.table_rows(name)
        for key, arr in st.items():
            val = torch.from_numpy(np.array(arr))
            cur = state[gk].get(key)
            if cur is not None and cur.dim() >= 1:
                cur[off:off + rows] = val.reshape(rows, -1).to(cur)
            else:
                state[gk][key] = val.to(device)
    return state


def dense_opt_state_from_jax(mu: Mapping[str, Any], nu: Mapping[str, Any],
                             count, param_names: Sequence[str]
                             ) -> Dict[str, Any]:
    """optax adam moments (pytrees shaped like the dense params) and step
    count -> ``DenseOptimizer.load_state_dict`` input, with the moments
    in the order of ``param_names`` (the model's parameter names)."""
    mu_sd, nu_sd = from_jax_state(mu, {}), from_jax_state(nu, {})
    return {
        "count": int(count),
        "state": [{"mu": mu_sd[n], "nu": nu_sd[n]} for n in param_names],
    }

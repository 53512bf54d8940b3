"""Carry weights across from the JAX package.

``from_jax_state(dense_params, tables)`` maps the JAX model's parameters
(numpy arrays, e.g. after ``jax.device_get``) onto this package's
``state_dict`` names:

- pytree paths join with "."; list entries by their index (the experts
  and gates of MMoE and PLE, nested for PLE's task experts, the towers
  and outputs of the multi-task models, MultiTowerDIN's ``din``, the
  sequence encoders ``embedding_group.encoders.<group>.<i>``); dicts
  keyed by tower or group name (DBMTL's ``towers``, ``relations``,
  ``outputs``; MultiTower's ``towers``) by that name; RocketLaunching's
  ``share``, ``booster``, ``light``, ``booster_out`` and ``light_out``
  keep their names, and so do the retrieval models' ``user_tower``,
  ``item_tower`` (each ``mlp`` and ``output``), TDM's ``mwdin`` (its
  attention ``mlp`` and ``linear``), ``final`` and ``output``, MIND's
  ``user_mlp``,
  ``hist_mlp``, ``concat_mlp`` and ``user_out``, and its capsule's
  ``bilinear`` [in, high] and ``routing_logits`` (not transposed);
  ``layer_<i>`` (MLP layers, cross layers, CIN layers) becomes
  ``layers.<i>`` and MaskNet's ``block_<i>`` becomes ``blocks.<i>``;
  WuKong's ``layers`` and PPNet's ``layers`` and ``gates`` are JAX lists
  and keep ``layers.<i>`` (PEPNet's ``ppnets.<i>.layers.<j>``); DC2VR's
  ``towers``, ``interventions`` and ``outputs`` are keyed by tower name;
- linear ``kernel`` [in, out] becomes ``weight`` [out, in], LayerNorm
  and batch-norm ``scale`` becomes ``weight``; a DCN v1 cross layer's
  ``w`` and ``b`` become ``weight`` and ``bias``; so does ``w`` of a CIN
  layer (``cin.layer_<i>.w``), of WuKong's ``lcb`` and
  ``residual_proj``, all [in, out] and not transposed; a batch norm's
  ``mean`` and ``var`` (an MLP's ``bn``, Dice's ``act.bn``) are the
  port's buffers of those names; PReLU's and Dice's ``act.alpha`` and
  ``variational_dropout.<group>.logit_p`` keep their names;
- the STU's ``uvqk_w`` [E, F] and ``output_w`` [H*ld, E] become
  ``uvqk_weight`` [F, E] and ``output_weight`` [E, H*ld], ``uvqk_b``
  becomes ``uvqk_bias``; the generative family's parameters keep their
  JAX names: the preprocessors' (``content_encoder`` with ``enrich`` or
  the ``uih``/``target`` MLPs, ``content_mlp`` and ``action_mlp`` with
  ``l1``, ``sln``, ``l2``, ``ln`` or ``compress``, ``raw_w``, ``w_norm``
  (an [in, out] LayerNorm), ``res1``, ``res_sln``, ``res2``, then
  ``ctx_proj``, ``action``, ``target_action``, the UIH preprocessor's
  ``proj``), ULTRA-HSTU's ``extra_stacks.<i>`` and HSTU-Match's
  ``item_tower`` and ``user_out``;
- ``tables`` ({table name: [rows, dim]}, canonical layout, as the JAX
  engine's ``extract_table`` gives them) become
  ``embedding_group.tables.<name>``, and the JAX state's ZCH mappings
  (``state["zch"]``) ``embedding_group.zch.<table>.<name>``; ``load_state_dict`` lays them into
  the port's groups, packed or not. DeepFM's dense parameters
  (``deep_mlp``, ``final_mlp``, ``output``) need no rule of their own.

The optimizer state crosses too, so the two packages can be held
together after step k and not only at step 0:
``sparse_opt_state_from_jax`` takes each table's state as the JAX
engine's ``extract_table_state`` gives it and lays it into this
package's state (into the rows of packed groups, whose tables it
therefore takes too); ``dense_opt_state_from_jax`` takes optax
adam's ``mu``, ``nu`` and ``count`` and gives a ``DenseOptimizer``
state dict.

``dense_param_paths(model)`` goes the other way for names: each dense
parameter's path as the JAX package's optimizer builder writes it
(``/``-joined, list entries as ``[i]``), which ``part_optimizers``'
regexes are matched against.

This module never imports JAX.
"""

import re
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

_TRANSPOSED = {"kernel": "weight", "uvqk_w": "uvqk_weight",
               "output_w": "output_weight"}
# "w" and "b": the DCN v1 cross layers; "w" also the CIN layers' and the
# WuKong blocks' [in, out] maps
_RENAMED = {"scale": "weight", "uvqk_b": "uvqk_bias", "w": "weight",
            "b": "bias"}


def _flatten(tree, prefix: str = ""):
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def from_jax_state(dense_params: Mapping[str, Any],
                   tables: Mapping[str, Any],
                   zch: Mapping[str, Mapping[str, Any]] = None
                   ) -> Dict[str, torch.Tensor]:
    """JAX dense params + canonical tables (+ the JAX state's ``zch``,
    {table: {keys, count, last[, admit_cnt]}}) -> a torch state_dict
    (fp32, the ZCH mappings in their own dtypes)."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(dense_params):
        if path.startswith("embedding_group.dense_emb."):
            raise NotImplementedError(
                f"{path}: dense embeddings are not ported")
        parts = re.sub(r"(^|\.)(layer|block)_(\d+)(?=\.)", r"\1\2s.\3",
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
    for name, st in (zch or {}).items():
        for k, arr in st.items():
            dt = np.int32 if k in ("keys", "last") else np.float32
            state[f"embedding_group.zch.{name}.{k}"] = torch.from_numpy(
                np.array(arr, dtype=dt))
    return state


# owning module class -> {port leaf: JAX leaf}
_LEAF_TO_JAX = {
    "Linear": {"weight": "kernel"},
    "LayerNorm": {"weight": "scale"},
    "BatchNorm": {"weight": "scale"},
    "CrossLayer": {"weight": "w", "bias": "b"},
    "CINLayer": {"weight": "w"},
    "LinearCompressBlock": {"weight": "w"},
    "STULayer": {"uvqk_weight": "uvqk_w", "uvqk_bias": "uvqk_b",
                 "output_weight": "output_w"},
}


# modules whose ``layers`` ModuleList is a JAX list ("layers/[i]"), not
# the "layer_<i>" keys of an MLP, the cross layers or CIN
_JAX_LIST_OWNERS = ("WuKong", "PPNet")


def dense_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: its JAX path}, the inverse of ``from_jax_state``'s
    renames: ``deep_mlp.layers.0.linear.weight`` is
    ``deep_mlp/layer_0/linear/kernel``, an entry of any other
    ``ModuleList`` is ``[i]`` (``towers.1.layers.0...`` is
    ``towers/[1]/layer_0/...``; WuKong's ``layers.0.lcb.weight`` is
    ``layers/[0]/lcb/w``), a LayerNorm's ``weight`` is ``scale``. Buffers
    (the batch norms' running statistics) are not parameters and have no
    path."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        mod, owner, path = model, None, []
        for part in parts[:-1]:
            if isinstance(mod, torch.nn.ModuleList):
                if (path and path[-1] in ("layers", "blocks")
                        and type(owner).__name__ not in _JAX_LIST_OWNERS):
                    path[-1] = f"{path[-1][:-1]}_{part}"
                else:
                    path.append(f"[{part}]")
            else:
                path.append(part)
            owner, mod = mod, mod._modules[part]
        path.append(_LEAF_TO_JAX.get(type(mod).__name__, {}).get(
            parts[-1], parts[-1]))
        out[name] = "/".join(path)
    return out


def sparse_opt_state_from_jax(
    engine, table_states: Mapping[str, Mapping[str, Any]],
    tables: Mapping[str, torch.Tensor],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """{table name: {state name: array}} (row state [rows, width] and
    scalars, as ``extract_table_state`` returns them) -> the engine's
    sparse optimizer state. ``tables`` is the engine's storage
    (``EmbeddingGroup.engine_tables()``): the row state of packed groups
    is written into it in place, the rest into the returned state."""
    device = next(iter(tables.values())).device
    state = engine.init_opt_state(device)
    for name, st in table_states.items():
        engine.write_table_state(
            tables, state, name,
            {k: torch.from_numpy(np.array(v)) for k, v in st.items()})
    return state


def dense_opt_state_from_jax(mu: Mapping[str, Any], nu: Mapping[str, Any],
                             count, param_names: Sequence[str]
                             ) -> Dict[str, Any]:
    """optax adam moments (pytrees shaped like the dense params) and step
    count -> ``DenseOptimizer.load_state_dict`` input, with the moments
    in the order of ``param_names`` (the model's parameter names). The
    moments the JAX package keeps for the batch norms' running
    statistics, which are buffers here, are left out."""
    mu_sd, nu_sd = from_jax_state(mu, {}), from_jax_state(nu, {})
    return {
        "count": int(count),
        "state": [{"mu": mu_sd[n], "nu": nu_sd[n]} for n in param_names],
    }

"""EmbeddingGroup: feature groups -> table lookups -> group assembly.

Counterpart of the parts of torcheasyrec_tpu/modules/embedding.py that
DEEP and (JAGGED_)SEQUENCE groups use (``__init__``, ``lookup`` and
``assemble``). The tables live in the embedding engine's fused
per-(dim, dtype) groups (``parallel/emb_engine.py``), held here as
buffers and not as parameters: the dense optimizer never sees them, and
the train step updates their touched rows in place through
``engine.update`` from the gradients of ``lookup``'s outputs. Features
sharing an ``embedding_name`` share one table. Lookups are gathers: id
-1 (padding) reads a zero row, pooled features sum (or average) their
rows. In the ``state_dict`` each table keeps its own entry
``tables.<name>`` in canonical ``[num_buckets, dim]`` layout, whatever
the grouping. WIDE groups, sequence encoders, dense embeddings, table
init functions and non-fp32 or host-offloaded tables raise
NotImplementedError.
"""

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.features.feature import BaseFeature
from torcheasyrec_tpu_torch.parallel.emb_engine import (
    EmbeddingEngine,
    LookupSpec,
    TableSpec,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.protos import model_pb2

Slot = Tuple[str, str, int]  # ("emb", lookup key, dim) | ("dense"|"seq_dense", feature, dim)


class EmbeddingGroup(nn.Module):
    def __init__(self, features: List[BaseFeature], feature_groups: List[Any],
                 generator: torch.Generator,
                 sparse_optimizer: Optional[SparseOptimizer] = None) -> None:
        super().__init__()
        self._name_to_feature = {f.name: f for f in features}
        shapes: Dict[str, Tuple[int, int]] = {}
        lookups: Dict[str, LookupSpec] = {}
        self._group_slots: Dict[str, List[Slot]] = {}
        self._seq_groups: Dict[str, Dict[str, Any]] = {}

        def _add_table(feat: BaseFeature, suffix: str) -> str:
            cfg = feat.emb_config()
            if cfg.init_fn:
                raise NotImplementedError(
                    f"table {cfg.name}: init_fn is not ported"
                )
            if (getattr(feat.config, "data_type", "FP32") or "FP32").upper() != "FP32":
                raise NotImplementedError(
                    f"table {cfg.name}: only FP32 tables are ported"
                )
            if "host_offload" in cfg.sharding_types:
                raise NotImplementedError(
                    f"table {cfg.name}: host_offload tables are not ported"
                )
            name = cfg.name + suffix
            shape = (cfg.num_embeddings, cfg.embedding_dim)
            if shapes.setdefault(name, shape) != shape:
                raise ValueError(
                    f"shared embedding {name}: conflicting shapes "
                    f"{shapes[name]} vs {shape}"
                )
            return name

        def _emb_slot(feat: BaseFeature, suffix: str, is_sequence: bool) -> Slot:
            table = _add_table(feat, suffix)
            key = f"{table}:{feat.name}" + (":seq" if is_sequence else "")
            lookups[key] = LookupSpec(
                key, feat.name, table,
                "none" if is_sequence else feat.pooling, is_sequence,
            )
            return ("emb", key, shapes[table][1])

        for group in feature_groups:
            gname = group.group_name
            suffix = getattr(group, "embedding_name_suffix", "") or ""
            if len(group.sequence_groups) or len(group.sequence_encoders):
                raise NotImplementedError(
                    f"group {gname}: sequence_groups / sequence_encoders "
                    "are not ported"
                )
            if group.group_type in (model_pb2.SEQUENCE,
                                    model_pb2.JAGGED_SEQUENCE):
                if gname in self._seq_groups:
                    raise ValueError(f"duplicate sequence group name {gname!r}")
                q_slots, s_slots, length_feature = [], [], None
                for fname in group.feature_names:
                    feat = self._name_to_feature[fname]
                    if feat.is_sequence:
                        s_slots.append(
                            _emb_slot(feat, suffix, True) if feat.is_sparse
                            else ("seq_dense", fname, max(feat.value_dim, 1))
                        )
                        length_feature = length_feature or fname
                    else:
                        q_slots.append(
                            _emb_slot(feat, suffix, False) if feat.is_sparse
                            else ("dense", fname, max(feat.value_dim, 1))
                        )
                if length_feature is None:
                    raise ValueError(
                        f"sequence group {gname} has no sequence feature"
                    )
                self._seq_groups[gname] = {
                    "query": q_slots, "sequence": s_slots,
                    "length_feature": length_feature,
                }
                continue
            if group.group_type != model_pb2.DEEP:
                raise NotImplementedError(
                    f"group {gname}: only DEEP and sequence groups are ported"
                )
            slots: List[Slot] = []
            for fname in group.feature_names:
                feat = self._name_to_feature[fname]
                if feat.is_sequence:
                    raise ValueError(
                        f"sequence feature {fname} must be in a SEQUENCE "
                        f"group (group {gname})"
                    )
                slots.append(
                    _emb_slot(feat, suffix, False) if feat.is_sparse
                    else ("dense", fname, max(feat.value_dim, 1))
                )
            self._group_slots[gname] = slots

        self.engine = EmbeddingEngine(
            [TableSpec(name, rows, dim) for name, (rows, dim) in shapes.items()],
            list(lookups.values()), optimizer=sparse_optimizer,
        )
        # one fused table per group, a buffer named after the group; each
        # table's slice gets the default init uniform(+-1/sqrt(rows)), as
        # the JAX package's default_emb_init
        for gk, g in self.engine.groups.items():
            self.register_buffer(
                f"group_{gk}",
                torch.empty(g.total_rows, g.dim, device=generator.device),
                persistent=False,
            )
        for name, (rows, _) in shapes.items():
            bound = 1.0 / max(rows, 1) ** 0.5
            self.tables[name].uniform_(-bound, bound, generator=generator)

    # -- tables ------------------------------------------------------------

    def engine_tables(self) -> Dict[str, torch.Tensor]:
        """{group key: fused [rows, dim] table}, as the engine takes them."""
        return {gk: getattr(self, f"group_{gk}") for gk in self.engine.groups}

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        """{table name: [num_buckets, dim] view into its fused group}."""
        fused = self.engine_tables()
        return {name: self.engine.extract_table(fused, name)
                for name in self.engine._specs}

    def init_opt_state(self) -> Dict[str, Any]:
        device = next(iter(self.engine_tables().values())).device
        return self.engine.init_opt_state(device)

    def _save_to_state_dict(self, destination, prefix, keep_vars) -> None:
        for name, t in self.tables.items():
            destination[f"{prefix}tables.{name}"] = (
                t if keep_vars else t.detach())

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs) -> None:
        tables = self.tables
        for name, t in tables.items():
            key = f"{prefix}tables.{name}"
            if key not in state_dict:
                missing_keys.append(key)
            elif state_dict[key].shape != t.shape:
                error_msgs.append(
                    f"size mismatch for {key}: {tuple(state_dict[key].shape)}"
                    f" in the checkpoint, {tuple(t.shape)} in the model")
            else:
                with torch.no_grad():
                    t.copy_(state_dict[key])
        if strict:
            unexpected_keys.extend(
                k for k in state_dict
                if k.startswith(prefix)
                and k[len(prefix) + len("tables."):] not in tables)

    # -- dims API ----------------------------------------------------------

    def group_dims(self, group_name: str) -> List[int]:
        if group_name in self._seq_groups:
            return [d for _, _, d in self._seq_groups[group_name]["sequence"]]
        return [d for _, _, d in self._group_slots[group_name]]

    def group_total_dim(self, group_name: str) -> int:
        return sum(self.group_dims(group_name))

    def seq_group_dims(self) -> Dict[str, int]:
        out = {}
        for name, sg in self._seq_groups.items():
            out[f"{name}.query"] = sum(d for _, _, d in sg["query"])
            out[f"{name}.sequence"] = sum(d for _, _, d in sg["sequence"])
        return out

    def has_group(self, group_name: str) -> bool:
        return group_name in self._group_slots or group_name in self._seq_groups

    # -- forward -----------------------------------------------------------

    def lookup(self, batch: Batch
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Engine lookup only: (emb_out, residuals). emb_out holds fp32
        lookups, [B, L, D] per sequence feature and [B, D] pooled. The
        train step takes gradients with respect to emb_out and routes
        them, with the residuals, to ``engine.update``."""
        return self.engine.lookup(
            self.engine_tables(), batch.sparse_features,
            batch.sequence_sparse_features,
        )

    def forward(self, batch: Batch,
                compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Lookup + ``assemble``, for eval and predict."""
        return self.assemble(self.lookup(batch)[0], batch, compute_dtype)

    def assemble(self, emb_out: Dict[str, torch.Tensor], batch: Batch,
                 compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Group concat, a pure function of ``emb_out``: ``{group}``
        [B, D] for DEEP groups; ``{g}.query``, ``{g}.sequence`` and
        ``{g}.sequence_length`` for sequence groups. Values are cast to
        ``compute_dtype``."""

        def _slot_value(slot: Slot) -> torch.Tensor:
            kind, key, _ = slot
            if kind == "emb":
                return emb_out[key].to(compute_dtype)
            if kind == "seq_dense":
                return batch.sequence_dense_features[key].values.to(
                    compute_dtype
                )
            return batch.dense_features[key].values.to(compute_dtype)

        result: Dict[str, torch.Tensor] = {}
        for name, sg in self._seq_groups.items():
            lf = sg["length_feature"]
            if lf in batch.sequence_sparse_features:
                lengths = batch.sequence_sparse_features[lf].lengths
            else:
                lengths = batch.sequence_dense_features[lf].lengths
            if sg["query"]:
                result[f"{name}.query"] = torch.cat(
                    [_slot_value(s) for s in sg["query"]], dim=-1
                )
            result[f"{name}.sequence"] = torch.cat(
                [_slot_value(s) for s in sg["sequence"]], dim=-1
            )
            result[f"{name}.sequence_length"] = lengths
        for gname, slots in self._group_slots.items():
            result[gname] = torch.cat([_slot_value(s) for s in slots], dim=-1)
        return result

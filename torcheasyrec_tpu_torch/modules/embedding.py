"""EmbeddingGroup: feature groups -> table lookups -> group assembly.

Counterpart of the parts of torcheasyrec_tpu/modules/embedding.py that
DEEP and (JAGGED_)SEQUENCE groups use (``__init__`` and ``assemble``).
Each table is one plain fp32 ``[num_buckets, dim]`` parameter in
canonical layout; features sharing an ``embedding_name`` share one
table. Lookups are gathers: id -1 (padding) reads a zero row, pooled
features sum (or average) their rows. The JAX package's sharded
embedding engine (packed megatable, sparse optimizers) arrives with
training. WIDE groups, sequence encoders, dense embeddings, table init
functions and non-fp32 or host-offloaded tables raise
NotImplementedError.
"""

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField
from torcheasyrec_tpu_torch.features.feature import BaseFeature
from torcheasyrec_tpu_torch.protos import model_pb2

Slot = Tuple[str, str, int]  # ("emb", lookup key, dim) | ("dense"|"seq_dense", feature, dim)


class EmbeddingGroup(nn.Module):
    def __init__(self, features: List[BaseFeature], feature_groups: List[Any],
                 generator: torch.Generator) -> None:
        super().__init__()
        self._name_to_feature = {f.name: f for f in features}
        shapes: Dict[str, Tuple[int, int]] = {}
        # lookup key -> (feature name, table name, combiner, is_sequence)
        self._lookups: Dict[str, Tuple[str, str, str, bool]] = {}
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
            self._lookups[key] = (
                feat.name, table, "none" if is_sequence else feat.pooling,
                is_sequence,
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

        # default init uniform(+-1/sqrt(rows)), as the JAX package's
        # default_emb_init
        self.tables = nn.ParameterDict()
        for name, (rows, dim) in shapes.items():
            t = torch.empty(rows, dim, device=generator.device)
            bound = 1.0 / max(rows, 1) ** 0.5
            t.uniform_(-bound, bound, generator=generator)
            self.tables[name] = nn.Parameter(t)

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

    def _gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of ``table`` for ``ids`` of any shape; id -1 reads zeros."""
        rows = table[ids.clamp(min=0).long()]
        return torch.where((ids >= 0)[..., None], rows, rows.new_zeros(()))

    def lookup(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """fp32 lookups: [B, L, D] per sequence feature, [B, D] pooled."""
        out = {}
        for key, (fname, tname, combiner, is_seq) in self._lookups.items():
            table = self.tables[tname]
            if is_seq:
                field = batch.sequence_sparse_features[fname]
                rows = self._gather(table, field.values)
                # multi-value steps [B, L, K] sum-pool their K ids
                out[key] = rows.sum(dim=2) if field.values.dim() == 3 else rows
                continue
            out[key] = self._pool(table, batch.sparse_features[fname],
                                  combiner)
        return out

    def _pool(self, table: torch.Tensor, field: SparseField,
              combiner: str) -> torch.Tensor:
        rows = self._gather(table, field.values)
        if field.weights is not None:
            rows = rows * field.weights[..., None]
        if field.is_fixed:
            b, length = field.values.shape
            pooled = rows.sum(dim=1)
            counts = torch.full((b,), float(length), device=rows.device)
        else:
            b = field.lengths.shape[0]
            n = field.values.shape[0]
            seg = torch.repeat_interleave(
                torch.arange(b, device=rows.device), field.lengths.long()
            )
            seg = torch.cat([seg, seg.new_full((n - seg.shape[0],), b)])
            pooled = rows.new_zeros(b + 1, rows.shape[-1]).index_add_(
                0, seg, rows
            )[:b]
            counts = field.lengths.float()
        if combiner == "mean":
            pooled = pooled / counts.clamp(min=1.0)[:, None]
        return pooled

    def forward(self, batch: Batch,
                compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Lookup + group concat: ``{group}`` [B, D] for DEEP groups;
        ``{g}.query``, ``{g}.sequence`` and ``{g}.sequence_length`` for
        sequence groups. Values are cast to ``compute_dtype``."""
        emb_out = self.lookup(batch)

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

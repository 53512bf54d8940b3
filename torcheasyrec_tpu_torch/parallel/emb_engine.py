"""Embedding engine: fused tables, lookups and in-step sparse updates.

Counterpart of the single-device, unpacked paths of
torcheasyrec_tpu/parallel/emb_engine.py. Tables of one (dim, dtype) are
stacked row-wise into one fused ``[rows, dim]`` table per group, each at
its row offset. ``lookup`` gathers a group's ids of every feature in one
pass and returns the outputs with residuals ``(flat_ids, plan)``;
``update`` turns the gradients of those outputs into per-row gradients,
sums duplicates (argsort + unique_consecutive + index_add_) and applies
the sparse optimizer to the touched rows in place. The gradient is taken
with respect to the looked-up rows, never as a dense ``[rows, dim]``
table gradient: rows the batch did not touch, and their optimizer
state, keep their bits.

The engine is a descriptor: tables and optimizer state are dicts of
tensors, keyed by group, that the caller holds. Not ported: co-keyed
table merge, packed 128-lane storage with in-row state, the dense lane,
meshes and sharded layouts, host-offloaded groups, ZCH. A group that
the JAX package would pack trains here on this unpacked path; the two
layouts agree to about 1 ulp per step.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from torcheasyrec_tpu_torch.datasets.utils import SparseField
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    rows: int
    dim: int
    dtype: str = "FP32"


@dataclasses.dataclass(frozen=True)
class LookupSpec:
    """One (feature -> table) pooled or per-position lookup."""

    key: str  # output key
    feature_name: str  # batch sparse field name
    table_name: str
    combiner: str = "sum"  # sum | mean | none (none = sequence per-position)
    is_sequence: bool = False


@dataclasses.dataclass
class _Group:
    """A fused table: same (dim, dtype) tables stacked row-wise."""

    dim: int
    dtype: str
    offsets: Dict[str, int]  # table name -> first row
    total_rows: int


@dataclasses.dataclass
class PlanEntry:
    """Per-lookup slice of a fused group's flat id vector."""

    lk: LookupSpec
    start: int
    count: int
    kind: str  # "pool" | "seq"
    seg: Optional[torch.Tensor]  # [count] sample index (b = padding), jagged
    weights: Optional[torch.Tensor]
    lengths: torch.Tensor
    shape: Tuple[int, ...]


def _group_key(dim: int, dtype: str = "FP32") -> str:
    base = f"d{dim}"
    return base if dtype.upper() == "FP32" else f"{base}_{dtype.lower()}"


def segment_ids_from_lengths(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """[n] sample index of each jagged slot; padding slots get b."""
    b = lengths.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(b, device=lengths.device), lengths.long())
    return torch.cat([seg, seg.new_full((n - seg.shape[0],), b)])


class EmbeddingEngine:
    def __init__(self, tables: Sequence[TableSpec],
                 lookups: Sequence[LookupSpec],
                 optimizer: Optional[SparseOptimizer] = None) -> None:
        self.optimizer = optimizer or SparseOptimizer("adagrad", {"lr": 0.001})
        self._specs = {t.name: t for t in tables}
        self.groups: Dict[str, _Group] = {}
        self._table_group: Dict[str, str] = {}
        for t in tables:
            gk = _group_key(t.dim, t.dtype)
            g = self.groups.setdefault(gk, _Group(t.dim, t.dtype, {}, 0))
            g.offsets[t.name] = g.total_rows
            g.total_rows += t.rows
            self._table_group[t.name] = gk
        self._lookups_by_group: Dict[str, List[LookupSpec]] = {}
        for lk in lookups:
            gk = self._table_group[lk.table_name]
            self._lookups_by_group.setdefault(gk, []).append(lk)

    # -- state -------------------------------------------------------------

    def init_opt_state(self, device=None) -> Dict[str, Any]:
        return {
            gk: self.optimizer.init_state(g.total_rows, g.dim, device)
            for gk, g in self.groups.items()
        }

    # -- forward lookup ------------------------------------------------------

    def lookup(
        self,
        tables: Dict[str, torch.Tensor],
        sparse: Dict[str, SparseField],
        sequence_sparse: Optional[Dict[str, SparseField]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """(outputs, residuals). outputs[key]: [B, dim] pooled, or
        [B, L, dim] for sequence lookups, fp32. residuals: per group
        ``(flat_ids, plan)`` for ``update``."""
        sequence_sparse = sequence_sparse or {}
        outputs: Dict[str, torch.Tensor] = {}
        residuals: Dict[str, Any] = {}
        for gk, lks in self._lookups_by_group.items():
            g = self.groups[gk]
            flat_ids, plan = self._flatten_group_ids(
                g, lks, sparse, sequence_sparse)
            weight = tables[gk]
            rows = weight[flat_ids.clamp(min=0)].float()
            rows = torch.where((flat_ids >= 0)[:, None], rows,
                               rows.new_zeros(()))
            self._emit_outputs(g, plan, rows, outputs)
            residuals[gk] = (flat_ids, plan)
        return outputs, residuals

    def _flatten_group_ids(self, g, lks, sparse, sequence_sparse):
        """All features' ids, offset into the fused table (-1 stays
        invalid), and the per-feature slicing plan."""
        ids_list, plan, pos = [], [], 0
        for lk in lks:
            off = g.offsets[lk.table_name]
            if lk.is_sequence:
                field = sequence_sparse[lk.feature_name]
                shape = tuple(field.values.shape)  # [B, L] or [B, L, K]
                v = field.values.long().reshape(-1)
                ids = torch.where(v >= 0, v + off, v.new_full((), -1))
                plan.append(PlanEntry(lk, pos, v.shape[0], "seq", None, None,
                                      field.lengths, shape))
            elif sparse[lk.feature_name].is_fixed:
                field = sparse[lk.feature_name]
                b, length = field.values.shape
                v = field.values.long().reshape(-1)
                ids = torch.where(v >= 0, v + off, v.new_full((), -1))
                w = (field.weights.reshape(-1)
                     if field.weights is not None else None)
                lengths = torch.full((b,), length, dtype=torch.int32,
                                     device=v.device)
                plan.append(PlanEntry(lk, pos, b * length, "pool", None, w,
                                      lengths, (b, length)))
            else:
                field = sparse[lk.feature_name]
                n = field.values.shape[0]
                b = field.lengths.shape[0]
                seg = segment_ids_from_lengths(field.lengths, n)
                v = field.values.long()
                # guard both padding slots and in-row -1 markers, so the
                # offset cannot alias another table's rows
                valid = (seg < b) & (v >= 0)
                ids = torch.where(valid, v + off, v.new_full((), -1))
                plan.append(PlanEntry(lk, pos, n, "pool", seg, field.weights,
                                      field.lengths, (b, n)))
            ids_list.append(ids)
            pos += ids.shape[0]
        flat = torch.cat(ids_list) if len(ids_list) > 1 else ids_list[0]
        return flat, plan

    def _emit_outputs(self, g, plan, rows, outputs) -> None:
        for e in plan:
            r = rows[e.start:e.start + e.count]
            if e.kind == "seq":
                if len(e.shape) == 3:
                    # multi-value steps: sum-pool the K id slots
                    b, length, k = e.shape
                    outputs[e.lk.key] = r.reshape(b, length, k, g.dim).sum(2)
                else:
                    outputs[e.lk.key] = r.reshape(*e.shape, g.dim)
                continue
            b = e.lengths.shape[0]
            if e.weights is not None:
                r = r * e.weights[:, None]
            if e.seg is not None:
                pooled = r.new_zeros(b + 1, g.dim).index_add_(0, e.seg, r)[:b]
            else:
                pooled = r.reshape(b, -1, g.dim).sum(dim=1)
            if e.lk.combiner == "mean":
                pooled = pooled / e.lengths.float().clamp(min=1.0)[:, None]
            outputs[e.lk.key] = pooled

    # -- backward: fused sparse updates --------------------------------------

    @torch.no_grad()
    def update(
        self,
        tables: Dict[str, torch.Tensor],
        opt_state: Dict[str, Any],
        residuals: Dict[str, Any],
        out_grads: Dict[str, torch.Tensor],
        lr_scale,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Apply the sparse optimizer from the gradients of the lookup
        outputs. Tables and row state are updated in place."""
        lr = lr_scale * self.optimizer.base_lr
        for gk, (flat_ids, plan) in residuals.items():
            g = self.groups[gk]
            grads = self._flat_row_grads(g, plan, out_grads)
            if grads is None:
                continue
            self._dedup_apply(tables[gk], opt_state[gk], flat_ids, grads, lr)
        return tables, opt_state

    def _flat_row_grads(self, g, plan, out_grads):
        """[n_flat, dim] gradient of every looked-up row slot, from the
        gradients of the outputs; None when no output has one."""
        pieces, any_grad = [], False
        for e in plan:
            og = out_grads.get(e.lk.key)
            if og is None:
                pieces.append(torch.zeros((e.count, g.dim),
                                          device=e.lengths.device))
                continue
            any_grad = True
            og = og.float()
            if e.kind == "seq":
                if len(e.shape) == 3:
                    b, length, k = e.shape
                    og = og[:, :, None, :].expand(b, length, k, g.dim)
                pieces.append(og.reshape(e.count, g.dim))
                continue
            b = e.lengths.shape[0]
            if e.lk.combiner == "mean":
                og = og / e.lengths.float().clamp(min=1.0)[:, None]
            if e.seg is not None:
                padded = torch.cat([og, og.new_zeros(1, g.dim)])
                rg = padded[e.seg]
            else:
                rg = og.repeat_interleave(e.count // b, dim=0)
            if e.weights is not None:
                rg = rg * e.weights[:, None]
            pieces.append(rg)
        if not any_grad:
            return None
        return torch.cat(pieces) if len(pieces) > 1 else pieces[0]

    def _dedup_apply(self, weight, state, ids, grads, lr):
        """Sum the gradients of duplicate ids, then apply the optimizer to
        the unique rows. Invalid slots (id < 0) are dropped first."""
        valid = ids >= 0
        ids, grads = ids[valid], grads[valid]
        order = torch.argsort(ids, stable=True)
        uids, inverse = torch.unique_consecutive(ids[order],
                                                 return_inverse=True)
        gsum = grads.new_zeros(uids.shape[0], grads.shape[1]).index_add_(
            0, inverse, grads[order])
        return self.optimizer.apply(weight, state, uids, gsum, lr)

    # -- per-table views -----------------------------------------------------

    def table_rows(self, table_name: str) -> Tuple[str, int, int]:
        """(group key, row offset, rows) of one table."""
        gk = self._table_group[table_name]
        return (gk, self.groups[gk].offsets[table_name],
                self._specs[table_name].rows)

    def extract_table(self, tables: Dict[str, torch.Tensor],
                      table_name: str) -> torch.Tensor:
        """[rows, dim] view of one table inside its fused group."""
        gk, off, rows = self.table_rows(table_name)
        return tables[gk][off:off + rows]

    def extract_table_state(self, tables: Dict[str, torch.Tensor],
                            opt_state: Dict[str, Any],
                            table_name: str) -> Dict[str, Any]:
        """Per-table optimizer state: the table's rows of every row-state
        array, and the group's scalars as they are."""
        gk, off, rows = self.table_rows(table_name)
        total = self.groups[gk].total_rows
        out: Dict[str, Any] = {}
        for k, v in (opt_state or {}).get(gk, {}).items():
            if v.dim() >= 1 and v.shape[0] == total:
                out[k] = v[off:off + rows]
            else:
                out[k] = v
        return out

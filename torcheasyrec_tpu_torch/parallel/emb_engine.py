"""Embedding engine: fused tables, lookups and in-step sparse updates.

Counterpart of the single-device paths of
torcheasyrec_tpu/parallel/emb_engine.py. Tables of one (dim, dtype) form
one group. ``lookup`` gathers a group's ids of every feature in one pass
and returns the outputs with residuals ``(flat_ids, plan)``; ``update``
turns the gradients of those outputs into per-row gradients, sums
duplicates (argsort + unique_consecutive + index_add_) and applies the
sparse optimizer to the touched rows in place. The gradient is taken
with respect to the looked-up rows, never as a dense ``[rows, dim]``
table gradient: rows the batch did not touch, and their optimizer
state, keep their bits.

Two storage layouts:

- unpacked: the group's tables stacked row-wise in one ``[rows, dim]``
  tensor, the optimizer's row state in separate ``[rows, width]``
  tensors of ``opt_state``;
- packed (``packed=True``, the default, for fp32 groups whose
  ``slot = dim + row-state width`` is at most 128): logical row r lives
  in physical row ``r // spr`` of a ``[p_rows, 128]`` tensor at lanes
  ``[(r % spr) * slot, (r % spr + 1) * slot)``, ``spr = 128 // slot``,
  weights first and then the optimizer's row state, so one gather brings
  a row and its state and one write puts both back. The last physical
  row is a scratch row that is never read. Each table starts on a
  physical-row boundary. The packed update gathers the touched physical
  rows once, runs the optimizer on the slots, merges the slots that
  share a physical row and writes whole rows back through
  ``ops/row_write.write_rows`` (the hand-written CUDA kernel on the
  card). Only the shared scalars (adam's step count) stay in
  ``opt_state``.

The dense lane (``dense_lane_rows``, default 32768, 0 turns it off): in a
packed group the tables of at most that many rows come first and form
one contiguous region. Their ids skip the sort: the region's gradient is
one ``index_add_``, the optimizer runs over the whole region (allowed
only for sgd, adagrad and rowwise_adagrad, whose zero-gradient update is
the identity) and the region is written back as one block.

Tables of ``data_type`` BF16 or FP16 are stored in that dtype and stay
unpacked, as in the JAX package: a lookup gathers and pools their rows
in the storage dtype (the outputs and their gradients have it), the
optimizer runs in fp32 on the touched rows and rounds the new rows to
the storage dtype on write; their row state is fp32. A table's
``init_fn`` (a torch-style init string) replaces the default init.

The engine is a descriptor: tables and optimizer state are dicts of
tensors, keyed by group, that the caller holds. Not ported: co-keyed
table merge, meshes and sharded layouts, host-offloaded groups, ZCH.
Packed and unpacked layouts agree to about 1 ulp per touched lane and
step (the packed merge adds a rounded difference).
"""

import math
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheasyrec_tpu_torch.datasets.utils import SparseField
from torcheasyrec_tpu_torch.modules.module import (
    default_emb_init,
    parse_init_fn,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    rows: int
    dim: int
    dtype: str = "FP32"  # storage: FP32 | BF16 | FP16
    init_fn: Optional[str] = None


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
    """Same (dim, dtype) tables stacked row-wise, unpacked or packed."""

    dim: int
    dtype: str
    offsets: Dict[str, int]  # table name -> first logical row
    total_rows: int  # logical rows; of a packed group padded to lcm(spr, 8)
    specs: List[TableSpec] = dataclasses.field(default_factory=list)
    packed: bool = False
    state_widths: Tuple[Tuple[str, int], ...] = ()
    slot: int = 0  # lanes of one logical row: dim + row-state widths
    spr: int = 1  # logical rows per 128-lane physical row
    p_rows: int = 0  # physical rows, the trailing scratch row included
    dense_rows: int = 0  # logical rows [0, dense_rows) are the dense lane
    dense_tables: frozenset = frozenset()

    @property
    def store_dtype(self) -> torch.dtype:
        return _STORE_DTYPES.get(self.dtype.upper(), torch.float32)


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


_STORE_DTYPES = {"FP32": torch.float32, "BF16": torch.bfloat16,
                 "FP16": torch.float16}


def _group_key(dim: int, dtype: str = "FP32") -> str:
    base = f"d{dim}"
    return base if dtype.upper() == "FP32" else f"{base}_{dtype.lower()}"


def segment_ids_from_lengths(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """[n] sample index of each jagged slot; padding slots get b. A
    search over the running lengths, so the shape is known without the
    data (``torch.export`` traces it, and the card does not wait)."""
    ends = torch.cumsum(lengths.long(), 0)
    pos = torch.arange(n, device=lengths.device)
    return torch.searchsorted(ends, pos, right=True)


def _slots(t: torch.Tensor, g: _Group) -> torch.Tensor:
    """[P, spr, slot] view of the packed rows ``t`` [P, 128]: entry
    [p, s] is the slot of logical row ``p * spr + s``."""
    return torch.as_strided(t, (t.shape[0], g.spr, g.slot),
                            (t.stride(0), g.slot, 1), t.storage_offset())


class EmbeddingEngine:
    # sparse optimizers whose zero-gradient update is the identity: the
    # dense lane applies the optimizer to every row of its region each
    # step, so rows the batch did not touch must come out unchanged
    _DENSE_LANE_OPTS = frozenset({"sgd", "adagrad", "rowwise_adagrad"})

    def __init__(self, tables: Sequence[TableSpec],
                 lookups: Sequence[LookupSpec],
                 optimizer: Optional[SparseOptimizer] = None,
                 packed: bool = True, dense_lane_rows: int = 32768) -> None:
        self.optimizer = optimizer or SparseOptimizer("adagrad", {"lr": 0.001})
        self._packed = bool(packed)
        self._dense_lane_rows = int(dense_lane_rows)
        self._specs = {t.name: t for t in tables}
        self.groups: Dict[str, _Group] = {}
        self._table_group: Dict[str, str] = {}
        for t in tables:
            gk = _group_key(t.dim, t.dtype)
            g = self.groups.setdefault(gk, _Group(t.dim, t.dtype, {}, 0))
            g.specs.append(t)
            self._table_group[t.name] = gk
        for g in self.groups.values():
            self._finalize_group(g)
        self._lookups_by_group: Dict[str, List[LookupSpec]] = {}
        for lk in lookups:
            gk = self._table_group[lk.table_name]
            self._lookups_by_group.setdefault(gk, []).append(lk)

    # -- layout --------------------------------------------------------------

    def _pack_params(self, g: _Group):
        """(state_widths, slot, spr) when the group packs, else None."""
        if not self._packed or g.dtype.upper() != "FP32":
            return None
        widths = tuple(self.optimizer.row_state_widths(g.dim))
        slot = g.dim + sum(w for _, w in widths)
        if slot > 128:
            return None
        return widths, slot, 128 // slot

    @staticmethod
    def _state_lanes(g: _Group):
        """(name, first lane within the slot, width) of each row state."""
        off = g.dim
        for name, width in g.state_widths:
            yield name, off, width
            off += width

    def _dense_lane_tables(self, g: _Group) -> set:
        """Names of a packed group's tables that take the dense lane."""
        if (self._dense_lane_rows <= 0
                or self.optimizer.kind not in self._DENSE_LANE_OPTS):
            return set()
        return {t.name for t in g.specs if t.rows <= self._dense_lane_rows}

    def _finalize_group(self, g: _Group) -> None:
        """Row offsets of the group's tables. An unpacked group stacks
        them as they come. A packed group puts the dense-lane tables
        first, starts every table on a physical-row boundary (a multiple
        of ``spr``) and pads its rows to a multiple of lcm(spr, 8), as
        the JAX engine does."""
        pk = self._pack_params(g)
        if pk is None:
            for t in g.specs:
                g.offsets[t.name] = g.total_rows
                g.total_rows += t.rows
            return
        g.state_widths, g.slot, g.spr = pk
        g.packed = True
        dense = self._dense_lane_tables(g)
        if dense:
            g.specs.sort(key=lambda t: t.name not in dense)
        pos = 0
        for t in g.specs:
            g.offsets[t.name] = pos
            pos += -(-t.rows // g.spr) * g.spr
            if t.name in dense:
                g.dense_rows = pos
        g.dense_tables = frozenset(dense)
        align = math.lcm(g.spr, 8)
        g.total_rows = -(-pos // align) * align
        g.p_rows = g.total_rows // g.spr + 1  # + the scratch row

    def _packed_phys(self, g: _Group, flat_ids: torch.Tensor):
        """Logical row -> (physical row, slot within it, invalid mask);
        an invalid id (< 0) maps to (0, 0)."""
        invalid = flat_ids < 0
        safe = flat_ids.clamp(min=0)
        return (torch.div(safe, g.spr, rounding_mode="floor"),
                safe % g.spr, invalid)

    def pack_group(self, g: _Group, w: torch.Tensor,
                   srows: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[total_rows, dim] weights and {name: [total_rows, width]} row
        state -> [p_rows, 128] physical rows (the last is the scratch
        row; lanes no slot covers are 0)."""
        parts = [w.float()] + [srows[name].float()
                               for name, _ in g.state_widths]
        body = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        out = torch.zeros(g.p_rows, 128, device=w.device)
        _slots(out[:-1], g).copy_(body.reshape(-1, g.spr, g.slot))
        return out

    def unpack_group(self, g: _Group, packed: torch.Tensor):
        """Inverse of ``pack_group``: (weights, {name: row state})."""
        return self._split_slot(
            g, _slots(packed[:-1], g).reshape(g.total_rows, g.slot))

    # -- state -------------------------------------------------------------

    def init_tables(self, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
        """{group key: storage}, every table drawn from its ``init_fn``
        (else the default uniform(+-1/sqrt(rows)), the JAX package's
        ``default_emb_init``) straight into its place in the storage
        dtype: an unpacked table's row slice, or a packed table's slot
        lanes, with the state lanes set from the optimizer's fill values.
        No ``[total_rows, slot]`` intermediate is built."""
        device = device or generator.device
        out: Dict[str, torch.Tensor] = {}
        fills = self.optimizer.row_state_init()
        for gk, g in self.groups.items():
            if g.packed:
                lane_fill = torch.zeros(128)
                for name, lo, width in self._state_lanes(g):
                    for s in range(g.spr):
                        lane_fill[s * g.slot + lo:s * g.slot + lo + width] = (
                            fills.get(name, 0.0))
                store = lane_fill.to(device).repeat(g.p_rows, 1)
            else:
                store = torch.zeros(g.total_rows, g.dim, device=device,
                                    dtype=g.store_dtype)
            out[gk] = store
            for t in g.specs:
                init = parse_init_fn(t.init_fn) or default_emb_init
                for view in self._weight_views(g, store, t.name):
                    init(view, generator, t.rows)
        return out

    def init_opt_state(self, device=None) -> Dict[str, Any]:
        """Per group: the optimizer's row state and scalars; of a packed
        group only the scalars (its row state lives in the rows)."""
        return {
            gk: (self.optimizer.scalar_state_init(device) if g.packed
                 else self.optimizer.init_state(g.total_rows, g.dim, device))
            for gk, g in self.groups.items()
        }

    # -- forward lookup ------------------------------------------------------

    def lookup(
        self,
        tables: Dict[str, torch.Tensor],
        sparse: Dict[str, SparseField],
        sequence_sparse: Optional[Dict[str, SparseField]] = None,
        feature_filter: Optional[set] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """(outputs, residuals). outputs[key]: [B, dim] pooled, or
        [B, L, dim] for sequence lookups, in the table's storage dtype
        (fp32 but for BF16 and FP16 tables). residuals: per group
        ``(flat_ids, plan)`` for ``update``. ``feature_filter`` keeps the
        lookups of the named features only (a tower's serving batch holds
        its own features alone); a group left with none is skipped."""
        sequence_sparse = sequence_sparse or {}
        outputs: Dict[str, torch.Tensor] = {}
        residuals: Dict[str, Any] = {}
        for gk, lks in self._lookups_by_group.items():
            if feature_filter is not None:
                lks = [lk for lk in lks if lk.feature_name in feature_filter]
                if not lks:
                    continue
            g = self.groups[gk]
            flat_ids, plan = self._flatten_group_ids(
                g, lks, sparse, sequence_sparse)
            rows = self._gather(g, tables[gk], flat_ids)
            self._emit_outputs(g, plan, rows, outputs)
            residuals[gk] = (flat_ids, plan)
        return outputs, residuals

    def _gather(self, g: _Group, weight: torch.Tensor,
                flat_ids: torch.Tensor) -> torch.Tensor:
        """rows[i] = logical row flat_ids[i] of the group, in its storage
        dtype; an invalid id (< 0) reads a zero row. Of a packed group exactly the
        slot's weight lanes are gathered, an exact copy (the JAX engine's
        one-hot multiply and dense-lane one-hot product give the same
        values)."""
        if g.packed:
            pid, lane, invalid = self._packed_phys(g, flat_ids)
            rows = _slots(weight, g)[:, :, :g.dim][pid, lane]
            valid = ~invalid
        else:
            rows = weight[flat_ids.clamp(min=0)]
            valid = flat_ids >= 0
        return torch.where(valid[:, None], rows, rows.new_zeros(()))

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
            if g.packed:
                self._packed_update(g, tables[gk], opt_state[gk], flat_ids,
                                    grads, lr, plan)
            else:
                self._dedup_apply(tables[gk], opt_state[gk], flat_ids, grads,
                                  lr)
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

    @staticmethod
    def _dedup(ids, grads, rows: int):
        """(unique ids ascending, their summed gradients). Ids outside
        [0, rows) are dropped first. ``unique_consecutive`` makes the host
        wait for the count of unique ids."""
        valid = (ids >= 0) & (ids < rows)
        ids, grads = ids[valid], grads[valid]
        order = torch.argsort(ids, stable=True)
        uids, inverse = torch.unique_consecutive(ids[order],
                                                 return_inverse=True)
        gsum = grads.new_zeros(uids.shape[0], grads.shape[1]).index_add_(
            0, inverse, grads[order])
        return uids, gsum

    def _dedup_apply(self, weight, state, ids, grads, lr):
        """Sum the gradients of duplicate ids, then apply the optimizer to
        the unique rows of an unpacked group."""
        uids, gsum = self._dedup(ids, grads, weight.shape[0])
        return self.optimizer.apply(weight, state, uids, gsum, lr)

    def _split_slot(self, g: _Group, rowv: torch.Tensor):
        """[K, slot] -> (weights [K, dim], {name: row state [K, width]})."""
        return rowv[:, :g.dim], {
            name: rowv[:, lo:lo + width]
            for name, lo, width in self._state_lanes(g)}

    def _apply_slots(self, g: _Group, rowv, gsum, lr, scalar_state):
        """The optimizer on [K, slot] slot values: (new [K, slot] values,
        new scalar state)."""
        w_rows, srows = self._split_slot(g, rowv)
        new_rows, new_srows, new_scalar = self.optimizer.apply_rows(
            w_rows, srows, gsum, lr, scalar_state)
        parts = [new_rows] + [new_srows[nm] for nm, _ in g.state_widths]
        return (torch.cat(parts, dim=1) if len(parts) > 1 else new_rows,
                new_scalar)

    def _dense_lane_update(self, g: _Group, table, flat_ids, grads, lr):
        """Update the dense-lane region, logical rows [0, dense_rows):
        its gradient by one ``index_add_`` (no sort; an invalid id adds
        into a spare row), the optimizer over every row of the region
        (rows without a gradient come out unchanged, see
        ``_DENSE_LANE_OPTS``) and one block written back in place."""
        n = g.dense_rows
        region = _slots(table[:n // g.spr], g)
        idx = torch.where(flat_ids < 0, flat_ids.new_full((), n), flat_ids)
        grad_region = grads.new_zeros(n + 1, g.dim).index_add_(
            0, idx, grads)[:n]
        new_body, _ = self._apply_slots(
            g, region.reshape(n, g.slot), grad_region, lr, {})
        region.copy_(new_body.reshape(region.shape))

    def _packed_update(self, g: _Group, table, scalar_state, flat_ids, grads,
                       lr, plan):
        """Fused update of a packed group, in place: dedup, one gather of
        the touched physical rows, the optimizer on the slots, the merge
        of slots that share a physical row, one row write.

        The merge is a delta merge: each slot's change is spread to its
        lanes of a zero 128-lane row, the spread rows of one physical row
        are summed onto its first entry (their lanes are disjoint and the
        rest is zero, so the sum is exact in any order) and added to the
        gathered row. ``fl(x + fl(y - x))`` may differ from ``y`` by 1 ulp,
        which is what sets the packed result 1 ulp from the unpacked one.
        The first entry of each physical row carries the merged row to
        its place; every later entry targets the scratch row, whose writes
        are dropped."""
        from torcheasyrec_tpu_torch.ops.row_write import write_rows

        if g.dense_rows:
            dense_e = [e for e in plan if e.lk.table_name in g.dense_tables]
            big_e = [e for e in plan if e.lk.table_name not in g.dense_tables]
            if dense_e:
                def pick(x, entries):
                    parts = [x[e.start:e.start + e.count] for e in entries]
                    return torch.cat(parts) if len(parts) > 1 else parts[0]
                self._dense_lane_update(g, table, pick(flat_ids, dense_e),
                                        pick(grads, dense_e), lr)
                if not big_e:
                    return
                flat_ids, grads = pick(flat_ids, big_e), pick(grads, big_e)
        uids, gsum = self._dedup(flat_ids, grads, g.total_rows)
        k = uids.shape[0]
        if k == 0:
            return
        pid = torch.div(uids, g.spr, rounding_mode="floor")
        lane = uids % g.spr
        ar = torch.arange(k, device=uids.device)
        phys = table[pid]  # [k, 128]; pid is nondecreasing
        rowv = _slots(phys, g)[ar, lane]  # [k, slot]
        new_slot, new_scalar = self._apply_slots(g, rowv, gsum, lr,
                                                 scalar_state)
        spread = torch.zeros_like(phys)
        _slots(spread, g)[ar, lane] = new_slot.float() - rowv
        head = torch.ones(k, dtype=torch.bool, device=uids.device)
        head[1:] = pid[1:] != pid[:-1]
        # position of the first entry of each entry's physical row
        first = torch.cummax(torch.where(head, ar, ar.new_zeros(())), 0)[0]
        merged = phys + torch.zeros_like(phys).index_add_(0, first, spread)
        scratch = g.p_rows - 1
        tgt = torch.where(head, pid, pid.new_full((), scratch))
        # the scratch row is the last: through the view without it, every
        # write to it falls past the end and is dropped (thousands of
        # 512-byte writes to one address would serialise on the card)
        write_rows(table[:scratch], tgt, merged)
        scalar_state.update(new_scalar)

    # -- per-table access ------------------------------------------------------

    def tables_for_features(self, feature_names) -> set:
        """Names of the tables the given features look up (the tables a
        tower artifact keeps)."""
        names = set(feature_names)
        return {lk.table_name for lks in self._lookups_by_group.values()
                for lk in lks if lk.feature_name in names}

    def export_weight_matrices(self, tables: Dict[str, torch.Tensor]
                               ) -> Dict[str, np.ndarray]:
        """{group key: [total_rows, dim] fp32 numpy weights}, whatever the
        layout (a packed group's weight lanes, without its row state or
        scratch row): the view the quantized export writes."""
        out = {}
        for gk, g in self.groups.items():
            t = tables[gk].detach()
            w = self.unpack_group(g, t)[0] if g.packed else t
            out[gk] = w.float().cpu().numpy()
        return out

    def import_weight_matrices(self, mats: Dict[str, Any],
                               device=None) -> Dict[str, torch.Tensor]:
        """Inverse of ``export_weight_matrices``: {group key: storage in
        this engine's layout} (the row state of packed rows at the
        optimizer's fill values; serving never reads it)."""
        fills = self.optimizer.row_state_init()
        out = {}
        for gk, w in mats.items():
            g = self.groups[gk]
            w = torch.as_tensor(np.asarray(w, np.float32), device=device)
            if g.packed:
                srows = {name: torch.full((g.total_rows, width),
                                          float(fills.get(name, 0.0)),
                                          device=w.device)
                         for name, width in g.state_widths}
                out[gk] = self.pack_group(g, w, srows)
            else:
                out[gk] = w.to(g.store_dtype)
        return out

    def table_rows(self, table_name: str) -> Tuple[str, int, int]:
        """(group key, first logical row, rows) of one table."""
        gk = self._table_group[table_name]
        return (gk, self.groups[gk].offsets[table_name],
                self._specs[table_name].rows)

    def _lane_views(self, g: _Group, store: torch.Tensor, table_name: str,
                    lo: int, width: int) -> List[torch.Tensor]:
        """Views into a packed group's ``store`` that cover lanes
        [lo, lo + width) of every slot of one table, in row order: the
        table's whole physical rows as [n, spr, width], then the used
        slots of its last, partly filled physical row as [rem, width]."""
        off, rows = g.offsets[table_name], self._specs[table_name].rows
        p0, full, rem = off // g.spr, rows // g.spr, rows % g.spr
        views = []
        if full:
            views.append(_slots(store[p0:p0 + full], g)[:, :, lo:lo + width])
        if rem:
            last = store[p0 + full:p0 + full + 1]
            views.append(_slots(last, g)[0, :rem, lo:lo + width])
        return views

    def _weight_views(self, g: _Group, store: torch.Tensor,
                      table_name: str) -> List[torch.Tensor]:
        """Views that cover exactly one table's weights in ``store``."""
        if g.packed:
            return self._lane_views(g, store, table_name, 0, g.dim)
        off, rows = g.offsets[table_name], self._specs[table_name].rows
        return [store[off:off + rows]]

    @staticmethod
    def _read_views(views: List[torch.Tensor], width: int) -> torch.Tensor:
        """The views' rows, in order, as one new [rows, width] tensor
        (never a view of the storage: a saved view drags the whole
        storage into the file)."""
        out = views[0].new_empty(
            sum(v.numel() for v in views) // width, width)
        pos = 0
        for v in views:
            n = v.numel() // width
            out[pos:pos + n].view(v.shape).copy_(v)
            pos += n
        return out

    @staticmethod
    def _fill_views(views: List[torch.Tensor], values: torch.Tensor) -> None:
        pos = 0
        for v in views:
            n = v.numel() // v.shape[-1]
            v.copy_(values[pos:pos + n].reshape(v.shape))
            pos += n

    def extract_table(self, tables: Dict[str, torch.Tensor],
                      table_name: str) -> torch.Tensor:
        """One table in canonical [rows, dim] layout: a view into an
        unpacked group, a copy out of a packed one (its rows are no 2-D
        view). Write through ``write_table``."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        views = self._weight_views(g, tables[gk], table_name)
        return self._read_views(views, g.dim) if g.packed else views[0]

    @torch.no_grad()
    def write_table(self, tables: Dict[str, torch.Tensor], table_name: str,
                    values: torch.Tensor) -> None:
        """Write a whole table, canonical [rows, dim], into its group's
        storage in place, under either layout. In-row optimizer state is
        left as it is."""
        gk = self._table_group[table_name]
        self._fill_views(
            self._weight_views(self.groups[gk], tables[gk], table_name),
            values.to(tables[gk]))

    def extract_table_state(self, tables: Dict[str, torch.Tensor],
                            opt_state: Dict[str, Any],
                            table_name: str) -> Dict[str, Any]:
        """Per-table optimizer state, whatever the layout: the table's
        rows of every row-state array (out of the rows of a packed
        group, out of ``opt_state`` otherwise) and the group's scalars as
        they are."""
        gk, off, rows = self.table_rows(table_name)
        g = self.groups[gk]
        st = (opt_state or {}).get(gk, {})
        if g.packed:
            out: Dict[str, Any] = {
                name: self._read_views(self._lane_views(
                    g, tables[gk], table_name, lo, width), width)
                for name, lo, width in self._state_lanes(g)}
            out.update(st)
            return out
        return {k: v[off:off + rows]
                if v.dim() >= 1 and v.shape[0] == g.total_rows else v
                for k, v in st.items()}

    @torch.no_grad()
    def write_table_state(self, tables: Dict[str, torch.Tensor],
                          opt_state: Dict[str, Any], table_name: str,
                          table_state: Dict[str, Any]) -> None:
        """Inverse of ``extract_table_state``: row state goes into the
        table's rows (packed) or its slice of ``opt_state`` (unpacked),
        in place; scalars replace the group's."""
        gk, off, rows = self.table_rows(table_name)
        g = self.groups[gk]
        lanes = {name: (lo, width) for name, lo, width in self._state_lanes(g)}
        for key, val in table_state.items():
            val = torch.as_tensor(val)
            cur = opt_state[gk].get(key)
            if g.packed and key in lanes:
                lo, width = lanes[key]
                self._fill_views(
                    self._lane_views(g, tables[gk], table_name, lo, width),
                    val.reshape(rows, width).to(tables[gk]))
            elif cur is not None and cur.dim() >= 1:
                cur[off:off + rows] = val.reshape(rows, -1).to(cur)
            else:
                opt_state[gk][key] = val.to(tables[gk].device)

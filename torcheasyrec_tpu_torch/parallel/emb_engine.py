"""Embedding engine: fused tables, lookups and in-step sparse updates.

Counterpart of the single-device paths of
torcheasyrec_tpu/parallel/emb_engine.py. Tables of one (dim, dtype) form
one group. ``lookup`` gathers a group's ids of every feature in one pass
and returns the outputs with residuals ``(flat_ids, plan)``; ``update``
turns the gradients of those outputs into per-row gradients, sums
duplicates (argsort + unique_consecutive + a segment sum) and applies
the sparse optimizer to the touched rows in place (the duplicates' sums
in one order on every run, ``_sorted_segment_sum``). The gradient is taken
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
one contiguous region. Their ids skip the dedup: the region's gradient
is one segment sum over the sorted ids, the optimizer runs over the whole region (allowed
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
table merge. Packed and unpacked layouts agree to about 1 ulp per
touched lane and step (the packed merge adds a rounded difference).

Host-offloaded tables (``host_offload``, one rank only): a group of its
own per dim, ``d<dim>_host_offload``, unpacked fp32 in host memory with
its optimizer row state beside it. A lookup gathers the batch's rows on
the host from the batch's host ids (``host_gather``; the caller may pass
them gathered as ``host_rows``) and copies them to the device; the
update brings the row gradients back and applies the same optimizer
code as an unpacked device group (sgd, adagrad, rowwise_adagrad, adam),
on the host. ``write_logical_rows`` writes the weight columns of given
logical rows under any layout (the ZCH spill tier's restores).

Sharded layouts (``shard``, a ``parallel/mesh.ShardContext``): the
counterpart of the JAX engine's mesh paths. Tables of one (dim,
sharding, dtype) form a group and each rank holds its part of it:

- ``row_wise``: the group's logical rows are block-sharded, rank r owns
  rows [r * rps, (r + 1) * rps); ``table_wise`` bin-packs whole tables
  into those blocks and ``table_row_wise`` packs them into one host's
  blocks (on one host it is ``row_wise``), so all three route an id to
  its owner ``id // rps``. A packed group's block is a packed group of
  its own, with its own scratch row, and kernel #3 writes it;
- ``column_wise``: every rank holds every row and ``dim / world`` of its
  columns, unpacked; the row-wise reductions of the optimizer are
  all-reduced over the ranks;
- ``data_parallel``: every rank holds the whole group, unpacked.

The lookup exchange sends the split sizes first (one small
``all_to_all``), then ids and rows with variable splits: exact, with no
capacity and no fallback. The update routes each rank's row gradients to
their owners, where a row that several ranks touched is updated once with
the summed gradient; a replicated group all-gathers (ids, gradients) and
every rank applies all of them in the same order. The dense lane is off
under a ``shard``, as on a JAX mesh. Every layout and world size holds,
row for row, the initial values one rank draws (``init_tables``): a
table of up to ``_INIT_CHUNK`` rows comes from the model's generator in
a one-rank engine's order (a rank replays those small draws), a larger
one chunk by chunk from generators seeded by (the model's seed, the
table's name, the chunk), so that a rank draws only the chunks that
cover its rows. The canonical
accessors (``extract_table``, ``write_table``, ``extract_table_state``,
``write_table_state``, ``read_rows``) are collective under a ``shard``:
every rank calls them in the same order.
"""

import math
import dataclasses
import logging
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheasyrec_tpu_torch.datasets.utils import SparseField
from torcheasyrec_tpu_torch.modules.module import (
    default_emb_init,
    parse_init_fn,
)
from torcheasyrec_tpu_torch.parallel.mesh import ShardContext
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer

logger = logging.getLogger("tzrec_tpu_torch")

ROW_WISE = "row_wise"
COLUMN_WISE = "column_wise"
TABLE_WISE = "table_wise"
TABLE_ROW_WISE = "table_row_wise"
DATA_PARALLEL = "data_parallel"
# weights and optimizer state in host memory (one rank only)
HOST_OFFLOAD = "host_offload"
_HOST_OPT_KINDS = {"sgd", "adagrad", "rowwise_adagrad", "adam"}
ALL_SHARDINGS = frozenset({
    ROW_WISE, COLUMN_WISE, TABLE_WISE, TABLE_ROW_WISE, DATA_PARALLEL,
    HOST_OFFLOAD,
})
# the reference's sharding types with no layout of their own, mapped as
# the JAX package maps them
COMPAT_SHARDING = {
    "table_column_wise": COLUMN_WISE,
    "grid_shard": ROW_WISE,
}
# layouts whose rows are block-sharded over the ranks
_ROW_SHARDED = (ROW_WISE, TABLE_WISE, TABLE_ROW_WISE)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    rows: int
    dim: int
    dtype: str = "FP32"  # storage: FP32 | BF16 | FP16
    init_fn: Optional[str] = None
    sharding: str = ROW_WISE  # used under a ShardContext only
    # embedding_constraints.sharding_types: the planner's options
    sharding_types: Tuple[str, ...] = ()


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
    # under a ShardContext: the layout and this rank's part. A row-sharded
    # group holds logical rows [row_lo, row_lo + local_rows), a
    # column-wise one columns [col_lo, col_lo + local_dim) of every row;
    # unsharded and replicated groups hold all of it
    sharding: str = ""
    row_lo: int = 0
    local_rows: int = 0
    col_lo: int = 0
    local_dim: int = 0

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


def _group_key(dim: int, dtype: str = "FP32", sharding: str = "") -> str:
    base = f"d{dim}_{sharding}" if sharding else f"d{dim}"
    return base if dtype.upper() == "FP32" else f"{base}_{dtype.lower()}"


def _chunk_seed(base: int, table: str, chunk: int) -> int:
    """The seed of one init chunk of one table."""
    return zlib.crc32(f"{base}:{table}:{chunk}".encode()) | (
        (zlib.crc32(table.encode()) & 0x7FFFFFFF) << 32)


def segment_ids_from_lengths(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """[n] sample index of each jagged slot; padding slots get b. A
    search over the running lengths, so the shape is known without the
    data (``torch.export`` traces it, and the card does not wait)."""
    ends = torch.cumsum(lengths.long(), 0)
    pos = torch.arange(n, device=lengths.device)
    return torch.searchsorted(ends, pos, right=True)


def _sorted_segment_sum(grads: torch.Tensor, order: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """[len(lengths), dim] sums of ``grads[order]`` over consecutive runs
    of ``lengths`` rows, each run summed left to right (``order`` a
    stable argsort of the ids): every run, rank and world size sums a
    row's gradients in one order, with no atomic adds (whose order on
    the card changes from run to run, and which the optimizers that
    normalise a gradient, or a ReLU near its kink downstream, turn into
    visible differences; replicas on several ranks would drift apart)."""
    if lengths.shape[0] == 0:
        return grads.new_zeros(0, grads.shape[1])
    return torch.segment_reduce(grads[order], "sum", lengths=lengths, axis=0)


def _fields_to_cpu(fields: Dict[str, SparseField]) -> Dict[str, SparseField]:
    """Sparse fields copied to the host (ids, lengths and weights)."""
    return {k: SparseField(*(None if t is None else t.cpu() for t in (
        f.values, f.lengths, f.weights))) for k, f in fields.items()}


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

    # logical rows of one init chunk, as in the JAX engine
    _INIT_CHUNK = 4 << 20

    def __init__(self, tables: Sequence[TableSpec],
                 lookups: Sequence[LookupSpec],
                 optimizer: Optional[SparseOptimizer] = None,
                 packed: bool = True, dense_lane_rows: int = 32768,
                 shard: Optional[ShardContext] = None) -> None:
        self.optimizer = optimizer or SparseOptimizer("adagrad", {"lr": 0.001})
        self._packed = bool(packed)
        self.shard = shard
        self.num_shards = shard.world if shard is not None else 1
        self.rank = shard.rank if shard is not None else 0
        # the dense lane rewrites a region every step: off when sharded,
        # as on a JAX mesh
        self._dense_lane_rows = int(dense_lane_rows) if shard is None else 0
        # the dense lane a one-rank engine of these tables would have: the
        # order in which it draws the small tables (``_one_rank_draws``)
        self._one_rank_lane = int(dense_lane_rows)
        spg = shard.local_world if shard is not None else 1
        while spg > 1 and self.num_shards % spg:
            spg -= 1
        self.shards_per_host = max(spg, 1)
        self._specs = {t.name: t for t in tables}
        self.groups: Dict[str, _Group] = {}
        self._table_group: Dict[str, str] = {}
        for t in tables:
            if self._is_host(t):
                sharding, dtype = self._check_host(t), "FP32"
            else:
                sharding = (self._resolve_sharding(t) if shard is not None
                            else "")
                dtype = t.dtype
            gk = _group_key(t.dim, dtype, sharding)
            g = self.groups.setdefault(
                gk, _Group(t.dim, dtype, {}, 0, sharding=sharding))
            g.specs.append(t)
            self._table_group[t.name] = gk
        for g in self.groups.values():
            self._finalize_group(g)
        self._lookups_by_group: Dict[str, List[LookupSpec]] = {}
        for lk in lookups:
            gk = self._table_group[lk.table_name]
            self._lookups_by_group.setdefault(gk, []).append(lk)

    # -- layout --------------------------------------------------------------

    @staticmethod
    def _is_host(t: TableSpec) -> bool:
        return COMPAT_SHARDING.get(t.sharding, t.sharding) == HOST_OFFLOAD

    def _check_host(self, t: TableSpec) -> str:
        """HOST_OFFLOAD where this engine can hold ``t`` on the host."""
        if self.num_shards > 1:
            raise NotImplementedError(
                f"table {t.name}: host_offload runs on one rank only (as "
                "in the JAX package); shard it row_wise instead")
        if self.optimizer.kind not in _HOST_OPT_KINDS:
            raise ValueError(
                f"table {t.name}: host_offload supports sparse optimizers "
                f"{sorted(_HOST_OPT_KINDS)}, not {self.optimizer.kind}")
        return HOST_OFFLOAD

    @property
    def has_host_groups(self) -> bool:
        return any(g.sharding == HOST_OFFLOAD for g in self.groups.values())

    def _resolve_sharding(self, t: TableSpec) -> str:
        """A table's layout under a ShardContext, as the JAX engine
        resolves it: the reference's extra names mapped, ``table_row_wise``
        on one host is ``row_wise``, ``column_wise`` needs the dim to
        split evenly (else ``row_wise``). Unlike the JAX engine, world
        size 1 keeps the layout, so that its exchanges run on one rank."""
        sharding = COMPAT_SHARDING.get(t.sharding, t.sharding)
        if sharding not in ALL_SHARDINGS:
            raise ValueError(
                f"table {t.name}: unknown sharding {t.sharding!r}; "
                f"supported: {sorted(ALL_SHARDINGS)} "
                f"(+compat {sorted(COMPAT_SHARDING)})")
        if (sharding == TABLE_ROW_WISE
                and self.shards_per_host >= self.num_shards):
            return ROW_WISE
        if sharding == COLUMN_WISE and t.dim % self.num_shards:
            logger.warning(
                f"table {t.name}: dim {t.dim} not divisible by "
                f"{self.num_shards} shards; column_wise -> row_wise")
            return ROW_WISE
        return sharding

    def _pack_params(self, g: _Group):
        """(state_widths, slot, spr) when the group packs, else None."""
        if not self._packed or g.dtype.upper() != "FP32":
            return None
        if g.sharding in (COLUMN_WISE, DATA_PARALLEL, HOST_OFFLOAD):
            # as in the JAX engine: column shards and replicas keep
            # [rows, dim]
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
        """Row offsets of the group's tables. Unsharded, an unpacked group
        stacks them as they come; a packed group puts the dense-lane
        tables first, starts every table on a physical-row boundary (a
        multiple of ``spr``) and pads its rows to a multiple of
        lcm(spr, 8), as the JAX engine does. Under a ShardContext the
        offsets are the JAX engine's mesh offsets (``_finalize_sharded``)."""
        if self.shard is not None and g.sharding != HOST_OFFLOAD:
            self._finalize_sharded(g)
            return
        g.local_dim = g.dim
        pk = self._pack_params(g)
        if pk is None:
            for t in g.specs:
                g.offsets[t.name] = g.total_rows
                g.total_rows += t.rows
            g.local_rows = g.total_rows
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
        g.local_rows = g.total_rows
        g.p_rows = g.total_rows // g.spr + 1  # + the scratch row

    def _finalize_sharded(self, g: _Group) -> None:
        """The JAX engine's ``_finalize_group`` on a mesh of
        ``num_shards`` devices: rows aligned to 8 (to lcm(spr, 8) and
        tables to ``spr`` when packed); ``table_wise`` bin-packs tables
        (largest first, onto the least loaded shard) into per-shard
        blocks, ``table_row_wise`` onto host groups; other layouts stack
        the tables and pad to a multiple of the shards. Then this rank's
        part: its block of rows, its columns, or all of it."""
        D = self.num_shards
        pk = self._pack_params(g)
        if pk is not None:
            g.state_widths, g.slot, g.spr = pk
            g.packed = True
        align = math.lcm(g.spr, 8) if g.packed else 8
        t_align = g.spr if g.packed else 1

        def _up(x: int) -> int:
            return -(-x // t_align) * t_align

        def _bin_pack(n_bins: int):
            loads, within, owner = [0] * n_bins, {}, {}
            for t in sorted(g.specs, key=lambda t: -t.rows):
                b = min(range(n_bins), key=lambda i: loads[i])
                owner[t.name], within[t.name] = b, loads[b]
                loads[b] += _up(t.rows)
            return loads, within, owner

        if g.sharding == TABLE_WISE and D > 1:
            loads, within, owner = _bin_pack(D)
            rps = -(-max(loads) // align) * align
            for t in g.specs:
                g.offsets[t.name] = owner[t.name] * rps + within[t.name]
            g.total_rows = rps * D
        elif g.sharding == TABLE_ROW_WISE and D > 1:
            spg = self.shards_per_host
            loads, within, owner = _bin_pack(D // spg)
            rps = -(-max(loads) // (spg * align)) * align
            for t in g.specs:
                g.offsets[t.name] = owner[t.name] * spg * rps + within[t.name]
            g.total_rows = rps * D
        else:
            pos = 0
            for t in g.specs:
                g.offsets[t.name] = pos
                pos += _up(t.rows)
            mult = D * align if g.sharding != COLUMN_WISE else align
            g.total_rows = -(-pos // mult) * mult
        g.local_rows, g.local_dim = g.total_rows, g.dim
        if g.sharding in _ROW_SHARDED:
            g.local_rows = g.total_rows // D
            g.row_lo = self.rank * g.local_rows
        elif g.sharding == COLUMN_WISE:
            g.local_dim = g.dim // D
            g.col_lo = self.rank * g.local_dim
        if g.packed:
            g.p_rows = g.local_rows // g.spr + 1  # + this block's scratch row

    def _packed_phys(self, g: _Group, flat_ids: torch.Tensor):
        """Logical row -> (physical row, slot within it, invalid mask);
        an invalid id (< 0) maps to (0, 0)."""
        invalid = flat_ids < 0
        safe = flat_ids.clamp(min=0)
        return (torch.div(safe, g.spr, rounding_mode="floor"),
                safe % g.spr, invalid)

    def pack_group(self, g: _Group, w: torch.Tensor,
                   srows: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[local_rows, dim] weights and {name: [local_rows, width]} row
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
            g, _slots(packed[:-1], g).reshape(g.local_rows, g.slot))

    # -- state -------------------------------------------------------------

    def _owned(self, g: _Group, table_name: str) -> Tuple[int, int, int]:
        """(first row within the table, rows, first local logical row) of
        the part of a table this rank holds; rows 0 when it holds none."""
        off, rows = g.offsets[table_name], self._specs[table_name].rows
        lo = max(off, g.row_lo)
        hi = min(off + rows, g.row_lo + g.local_rows)
        if hi <= lo:
            return 0, 0, 0
        return lo - off, hi - lo, lo - g.row_lo

    def _one_rank_draws(self):
        """(table spec, [(shape, dtype)]) of every table of at most
        ``_INIT_CHUNK`` rows, in the order, shapes and dtypes in which a
        one-rank engine of these tables (this engine's ``packed`` and
        dense lane) draws them: a packed table's whole physical rows as
        [n, spr, dim], then its last slots as [rem, dim]; an unpacked
        one as [rows, dim] in its storage dtype."""
        # host tables draw as device tables would: offloading a table
        # changes no table's values and no dense weight
        eng = self if self.shard is None and not self.has_host_groups \
            else EmbeddingEngine(
                [dataclasses.replace(t, sharding=ROW_WISE) if self._is_host(t)
                 else t for t in self._specs.values()], [], self.optimizer,
                packed=self._packed, dense_lane_rows=self._one_rank_lane)
        for g in eng.groups.values():
            for t in g.specs:
                if t.rows > self._INIT_CHUNK:
                    continue
                if g.packed:
                    full, rem = divmod(t.rows, g.spr)
                    shapes = ([((full, g.spr, g.dim), torch.float32)]
                              if full else [])
                    shapes += [((rem, g.dim), torch.float32)] if rem else []
                else:
                    shapes = [((t.rows, g.dim), g.store_dtype)]
                yield t, shapes

    def init_tables(self, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
        """{group key: storage}, every table drawn from its ``init_fn``
        (else the default uniform(+-1/sqrt(rows)), the JAX package's
        ``default_emb_init``), so that every layout and world size holds
        the values one rank draws:
        - a table of at most ``_INIT_CHUNK`` rows from ``generator``
          itself, in a one-rank engine's order (``_one_rank_draws``):
          straight into its place on one rank; a rank of several replays
          the draws and keeps its rows (these tables are small);
        - a larger one chunk by chunk: chunk c (rows [c * _INIT_CHUNK,
          ...), fp32) from a generator seeded by ``_chunk_seed`` of
          ``generator``'s seed, the table and c, so that a rank draws
          only the chunks that cover its rows.
        Each is written in the storage dtype: an unpacked group's rows (a
        column-wise rank's columns), or a packed group's slot lanes, whose
        state lanes start at the optimizer's fill values."""
        device = device or generator.device
        gen_dev = generator.device
        out: Dict[str, torch.Tensor] = {}
        fills = self.optimizer.row_state_init()
        replay = self.shard is not None or self.has_host_groups
        for gk, g in self.groups.items():
            if g.sharding == HOST_OFFLOAD:
                out[gk] = torch.zeros(g.local_rows, g.dim)
            elif g.packed:
                lane_fill = torch.zeros(128)
                for name, lo, width in self._state_lanes(g):
                    for s in range(g.spr):
                        lane_fill[s * g.slot + lo:s * g.slot + lo + width] = (
                            fills.get(name, 0.0))
                out[gk] = lane_fill.to(device).repeat(g.p_rows, 1)
            else:
                out[gk] = torch.zeros(g.local_rows, g.local_dim,
                                      device=device, dtype=g.store_dtype)

        def put(g, store, t, first, vals):
            """Rows [first, first + len(vals)) of table t, where this rank
            holds them."""
            a, n, s0 = self._owned(g, t.name)
            lo, hi = max(first, a), min(first + vals.shape[0], a + n)
            if hi > lo:
                self._fill_views(
                    self._range_views(g, store, s0 + lo - a, hi - lo, 0,
                                      g.local_dim),
                    vals[lo - first:hi - first,
                         g.col_lo:g.col_lo + g.local_dim].to(store))

        for t, shapes in self._one_rank_draws():
            init = parse_init_fn(t.init_fn) or default_emb_init
            g = self.groups[self._table_group[t.name]]
            store = out[self._table_group[t.name]]
            if not replay:
                _, n, s0 = self._owned(g, t.name)
                for view in self._range_views(g, store, s0, n, 0, g.dim):
                    init(view, generator, t.rows)
                continue
            parts = []
            for shape, dtype in shapes:
                v = torch.empty(shape, device=gen_dev, dtype=dtype)
                init(v, generator, t.rows)
                parts.append(v.reshape(-1, t.dim))
            put(g, store, t, 0, torch.cat(parts) if len(parts) > 1
                else parts[0])
        base = generator.initial_seed()
        for gk, g in self.groups.items():
            for t in g.specs:
                if t.rows <= self._INIT_CHUNK:
                    continue
                init = parse_init_fn(t.init_fn) or default_emb_init
                a, n, _ = self._owned(g, t.name)
                for c, p0 in enumerate(range(0, t.rows, self._INIT_CHUNK)):
                    cn = min(self._INIT_CHUNK, t.rows - p0)
                    if min(p0 + cn, a + n) <= max(p0, a):
                        continue
                    gen = torch.Generator(device=gen_dev)
                    gen.manual_seed(_chunk_seed(base, t.name, c))
                    vals = torch.empty(cn, t.dim, device=gen_dev)
                    init(vals, gen, t.rows)
                    put(g, out[gk], t, p0, vals)
        return out

    def init_opt_state(self, device=None) -> Dict[str, Any]:
        """Per group: the optimizer's row state and scalars; of a packed
        group only the scalars (its row state lives in the rows)."""
        return {
            gk: (self.optimizer.scalar_state_init(device) if g.packed
                 else self.optimizer.init_state(
                     g.local_rows, g.local_dim,
                     "cpu" if g.sharding == HOST_OFFLOAD else device))
            for gk, g in self.groups.items()
        }

    # -- forward lookup ------------------------------------------------------

    def lookup(
        self,
        tables: Dict[str, torch.Tensor],
        sparse: Dict[str, SparseField],
        sequence_sparse: Optional[Dict[str, SparseField]] = None,
        feature_filter: Optional[set] = None,
        host_rows: Optional[Dict[str, Any]] = None,
        host_fields=None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """(outputs, residuals). outputs[key]: [B, dim] pooled, or
        [B, L, dim] for sequence lookups, in the table's storage dtype
        (fp32 but for BF16 and FP16 tables). residuals: per group
        ``(flat_ids, plan)`` for ``update``, and under a ShardContext the
        exchange's route as a third entry; of a host group the host ids
        as third entry. ``feature_filter`` keeps the
        lookups of the named features only (a tower's serving batch holds
        its own features alone); a group left with none is skipped.
        Host groups read ``host_rows`` ({group: (device rows, host ids)},
        ``host_gather``'s) where given, else gather now from
        ``host_fields`` ((sparse, sequence sparse) on the host; without
        them the batch's ids are copied off the device)."""
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
            if g.sharding == HOST_OFFLOAD:
                got = (host_rows or {}).get(gk)
                if got is None:
                    hs, hq = host_fields or (_fields_to_cpu(sparse),
                                             _fields_to_cpu(sequence_sparse))
                    got = self.host_gather(tables, hs, hq, feature_filter,
                                           groups=[gk])[gk]
                rows = got[0].to(flat_ids.device, non_blocking=True)
                residuals[gk] = (flat_ids, plan, got[1])
            elif self.shard is None:
                rows = self._gather(g, tables[gk], flat_ids)
                residuals[gk] = (flat_ids, plan)
            else:
                rows, route = self._sharded_gather(g, tables[gk], flat_ids)
                residuals[gk] = (flat_ids, plan, route)
            self._emit_outputs(g, plan, rows, outputs)
        return outputs, residuals

    def _gather(self, g: _Group, weight: torch.Tensor,
                flat_ids: torch.Tensor) -> torch.Tensor:
        """rows[i] = local logical row flat_ids[i] of the group, in its
        storage dtype; an invalid id (< 0) reads a zero row. Of a packed
        group exactly the slot's weight lanes are gathered, an exact copy
        (the JAX engine's one-hot multiply and dense-lane one-hot product
        give the same values)."""
        if g.packed:
            pid, lane, invalid = self._packed_phys(g, flat_ids)
            rows = _slots(weight, g)[:, :, :g.dim][pid, lane]
            valid = ~invalid
        else:
            rows = weight[flat_ids.clamp(min=0)]
            valid = flat_ids >= 0
        return torch.where(valid[:, None], rows, rows.new_zeros(()))

    def _owner_route(self, g: _Group, flat_ids: torch.Tensor):
        """The ids of a row-sharded group sent to their owners:
        (positions of the valid ids in owner order, the owner-ordered
        ids, split sizes sent, split sizes received, the ids received)."""
        sh = self.shard
        valid = flat_ids >= 0
        owner = torch.where(valid, torch.div(flat_ids, g.local_rows,
                                             rounding_mode="floor"),
                            flat_ids.new_full((), self.num_shards))
        order = torch.argsort(owner, stable=True)
        send = torch.bincount(owner, minlength=self.num_shards + 1)
        send = [int(x) for x in send[:self.num_shards].tolist()]
        order = order[:sum(send)]
        recv = sh.exchange_counts(send)
        rids = sh.all_to_all(flat_ids[order], send, recv)
        return order, send, recv, rids

    def _sharded_gather(self, g: _Group, weight: torch.Tensor,
                        flat_ids: torch.Tensor):
        """(rows of ``flat_ids`` as ``_gather`` gives them on one rank,
        the route ``update`` sends the gradients back along)."""
        sh = self.shard
        if g.sharding == DATA_PARALLEL:
            return self._gather(g, weight, flat_ids), None
        if g.sharding == COLUMN_WISE:
            # every rank's ids; each rank gathers its columns of all of
            # them and sends each rank its own ids' columns
            ids_all, counts = sh.all_gather_var(flat_ids)
            part = self._gather(g, weight, ids_all)
            n = flat_ids.shape[0]
            back = sh.all_to_all(part, counts, [n] * self.num_shards)
            rows = back.reshape(self.num_shards, n, g.local_dim).permute(
                1, 0, 2).reshape(n, g.dim)
            return rows, (ids_all, counts)
        order, send, recv, rids = self._owner_route(g, flat_ids)
        local = self._gather(g, weight, rids - g.row_lo)
        back = sh.all_to_all(local, recv, send)
        rows = back.new_zeros((flat_ids.shape[0], g.dim))
        rows[order] = back
        return rows, (order, send, recv, rids)

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
                # the rows lie in row order, padding last: a segment sum
                # adds each row's values in one order (atomic adds would
                # let two equal rows differ on the card); unchecked, it
                # reads no row past the last segment's
                pooled = torch.segment_reduce(
                    r, "sum", lengths=e.lengths, axis=0, unsafe=True)
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
        outputs. Tables and row state are updated in place. Under a
        ShardContext the gradients are this rank's share of the global
        loss's (the caller scales them); they travel to the rows'
        owners."""
        lr = lr_scale * self.optimizer.base_lr
        for gk, (flat_ids, plan, *route) in residuals.items():
            g = self.groups[gk]
            grads = self._flat_row_grads(g, plan, out_grads)
            if grads is None:
                continue
            if g.sharding == HOST_OFFLOAD:
                self._host_apply(tables[gk], opt_state[gk], route[0], grads,
                                 lr)
            elif self.shard is not None:
                self._sharded_update(g, tables[gk], opt_state[gk], flat_ids,
                                     grads, lr, route[0])
            elif g.packed:
                self._packed_update(g, tables[gk], opt_state[gk], flat_ids,
                                    grads, lr, plan)
            else:
                self._dedup_apply(tables[gk], opt_state[gk], flat_ids, grads,
                                  lr)
        return tables, opt_state

    # -- host-offloaded groups -------------------------------------------------

    def host_gather(self, tables: Dict[str, torch.Tensor], sparse,
                    sequence_sparse=None, feature_filter: Optional[set] = None,
                    groups=None, pin: bool = False
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """{host group: (rows [n, dim] fp32, ids [n])} of the batch, on the
        host, from host fields: the group's flat ids as ``lookup``
        flattens them (the same order and validity) and their rows, an
        invalid id's zero. With ``pin`` (and CUDA present) the rows go
        into page-locked memory, so the copy to the card can be queued
        (not while a program is traced: export cannot trace the pin)."""
        out = {}
        for gk, lks in self._lookups_by_group.items():
            g = self.groups[gk]
            if g.sharding != HOST_OFFLOAD or (groups is not None
                                              and gk not in groups):
                continue
            if feature_filter is not None:
                lks = [lk for lk in lks if lk.feature_name in feature_filter]
                if not lks:
                    continue
            flat, _ = self._flatten_group_ids(g, lks, sparse,
                                              sequence_sparse or {})
            rows = self._gather(g, tables[gk], flat)
            if pin and torch.cuda.is_available():
                rows = rows.pin_memory()
            out[gk] = (rows, flat)
        return out

    def _host_apply(self, table, state, ids, grads, lr) -> None:
        """The optimizer on a host group's touched rows, on the host, by
        the code of an unpacked device group; a zero learning rate
        updates nothing (no moment moves), as in the JAX package."""
        lr = float(lr)
        if lr == 0.0:
            return
        self._dedup_apply(table, state, ids, grads.float().cpu(), lr)

    @torch.no_grad()
    def write_logical_rows(self, weight: torch.Tensor, g: _Group,
                           flat_ids: torch.Tensor,
                           rows: torch.Tensor) -> None:
        """``rows[i]`` ([N, d]) into columns [0, d) of logical row
        ``flat_ids[i]`` of the group, in place, under any layout; id -1
        is dropped, of duplicates the last wins. Weight columns only:
        the in-row optimizer state of a packed group stays (a restored
        key restarts its optimizer state). A packed group's touched
        physical rows are gathered, their slots set and written back by
        the row write (kernel #3). Under a ShardContext each rank writes
        what it holds of the given rows: of a row-sharded group the rows
        in its block, of a column-wise one its columns of every row, of
        a replicated one all (not a collective: a caller whose ranks hold
        different rows routes them first)."""
        flat_ids = flat_ids.long().to(weight.device)
        rows = rows.to(weight.device)
        keep = flat_ids >= 0
        if g.sharding in _ROW_SHARDED:
            keep &= (flat_ids >= g.row_lo) & (
                flat_ids < g.row_lo + g.local_rows)
        ids, rows = flat_ids[keep] - g.row_lo, rows[keep]
        if g.sharding == COLUMN_WISE:
            rows = rows[:, g.col_lo:g.col_lo + g.local_dim]
        if ids.numel() == 0 or rows.shape[1] == 0:
            return
        uids, inv = torch.unique(ids, return_inverse=True)
        last = torch.full((uids.shape[0],), -1, dtype=torch.long,
                          device=ids.device).scatter_reduce(
            0, inv, torch.arange(ids.shape[0], device=ids.device), "amax")
        vals = rows[last]
        d = vals.shape[1]
        if g.packed:
            from torcheasyrec_tpu_torch.ops.row_write import write_rows

            pid, lane, _ = self._packed_phys(g, uids)
            upid, pinv = torch.unique_consecutive(pid, return_inverse=True)
            phys = weight[upid]
            _slots(phys, g)[pinv, lane, :d] = vals.to(weight.dtype)
            # the scratch row stays out of the view, as in the update
            write_rows(weight[:g.p_rows - 1], upid, phys)
        else:
            weight[uids, :d] = vals.to(weight.dtype)

    def _sharded_update(self, g: _Group, table, state, flat_ids, grads, lr,
                        route) -> None:
        """The update of one group under a ShardContext: a replicated
        group applies every rank's (ids, gradients); a column-wise rank
        receives its columns of every rank's gradients and all-reduces the
        optimizer's row-wise reductions; a row-sharded rank receives the
        gradients of the rows it owns and updates them as one rank would
        (packed: through the row write)."""
        sh = self.shard
        if g.sharding == DATA_PARALLEL:
            ids_all, _ = sh.all_gather_var(flat_ids)
            grads_all, _ = sh.all_gather_var(grads)
            # every replica applies the same sums (``_sorted_segment_sum``)
            self._dedup_apply(table, state, ids_all, grads_all, lr)
            return
        if g.sharding == COLUMN_WISE:
            ids_all, counts = route
            n = flat_ids.shape[0]
            pieces = grads.reshape(n, self.num_shards, g.local_dim).permute(
                1, 0, 2).reshape(n * self.num_shards, g.local_dim)
            mine = sh.all_to_all(pieces, [n] * self.num_shards, counts)
            self._dedup_apply(table, state, ids_all, mine, lr,
                              dim_reduce=sh.all_reduce, full_dim=g.dim)
            return
        order, send, recv, rids = route
        rg = sh.all_to_all(grads[order], send, recv)
        local_ids = rids - g.row_lo
        if g.packed:
            self._packed_update(g, table, state, local_ids, rg, lr, [])
        else:
            self._dedup_apply(table, state, local_ids, rg, lr)

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
        """(unique ids ascending, their summed gradients, each sum in one
        order on every run: ``_sorted_segment_sum``). Ids outside [0,
        rows) are dropped first. ``unique_consecutive`` makes the host
        wait for the count of unique ids."""
        valid = (ids >= 0) & (ids < rows)
        ids, grads = ids[valid], grads[valid]
        order = torch.argsort(ids, stable=True)
        uids, counts = torch.unique_consecutive(ids[order],
                                                return_counts=True)
        return uids, _sorted_segment_sum(grads, order, counts)

    def _dedup_apply(self, weight, state, ids, grads, lr, dim_reduce=None,
                     full_dim=None):
        """Sum the gradients of duplicate ids, then apply the optimizer to
        the unique rows of an unpacked group."""
        uids, gsum = self._dedup(ids, grads, weight.shape[0])
        return self.optimizer.apply(weight, state, uids, gsum, lr,
                                    dim_reduce=dim_reduce, full_dim=full_dim)

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
        its gradient by one segment sum over the sorted ids, a run for
        each row of the region whatever the batch (no dedup, so the host
        does not wait; an invalid id adds into a spare row), the
        optimizer over every row of the region (rows without a gradient
        come out unchanged, see ``_DENSE_LANE_OPTS``) and one block
        written back in place."""
        n = g.dense_rows
        region = _slots(table[:n // g.spr], g)
        idx = torch.where(flat_ids < 0, flat_ids.new_full((), n), flat_ids)
        grad_region = _sorted_segment_sum(
            grads, torch.argsort(idx, stable=True),
            torch.bincount(idx, minlength=n + 1))[:n]
        new_body, _ = self._apply_slots(
            g, region.reshape(n, g.slot), grad_region, lr, {})
        region.copy_(new_body.reshape(region.shape))

    def _packed_update(self, g: _Group, table, scalar_state, flat_ids, grads,
                       lr, plan):
        """Fused update of a packed group (or of a rank's packed block),
        in place: dedup, one gather of the touched physical rows, the
        optimizer on the slots, the merge of slots that share a physical
        row, one row write.

        The merge is a delta merge: each slot's change is spread to its
        lanes of a zero 128-lane row, the spread rows of one physical row
        are summed onto its first entry (their lanes are disjoint and the
        rest is zero, so the sum is exact in any order) and added to the
        gathered row. ``fl(x + fl(y - x))`` may differ from ``y`` by 1 ulp,
        which is what sets the packed result 1 ulp from the unpacked one.
        The first entry of each physical row carries the merged row to
        its place; every later entry targets the scratch row, whose writes
        are dropped. With no touched row the shared scalars (adam's step)
        still move and nothing is written."""
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
        uids, gsum = self._dedup(flat_ids, grads, g.local_rows)
        k = uids.shape[0]
        if k == 0:
            empty = grads.new_zeros(0, g.slot)
            scalar_state.update(self._apply_slots(
                g, empty, grads.new_zeros(0, g.dim), lr, scalar_state)[1])
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
        scratch row): the view the quantized export writes. One rank
        only."""
        self._one_rank("export_weight_matrices")
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
        optimizer's fill values; serving never reads it). One rank
        only."""
        self._one_rank("import_weight_matrices")
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

    def _one_rank(self, what: str) -> None:
        if self.num_shards > 1:
            raise NotImplementedError(
                f"{what} runs on one rank; export and predict under "
                "several ranks are not ported")

    def table_rows(self, table_name: str) -> Tuple[str, int, int]:
        """(group key, first logical row, rows) of one table."""
        gk = self._table_group[table_name]
        return (gk, self.groups[gk].offsets[table_name],
                self._specs[table_name].rows)

    def _range_views(self, g: _Group, store: torch.Tensor, start: int,
                     n: int, lo: int, width: int) -> List[torch.Tensor]:
        """Views into ``store`` that cover columns (of a packed group:
        slot lanes) [lo, lo + width) of local logical rows [start, start +
        n), in row order. Of a packed group: the used slots of a first,
        partly covered physical row as [k, width], the whole physical
        rows as [m, spr, width], the slots of a last partly covered one."""
        if not g.packed:
            return [store[start:start + n, lo:lo + width]] if n else []
        views, end = [], start + n
        if start % g.spr and start < end:
            p, a = start // g.spr, start % g.spr
            b = min(g.spr, a + n)
            views.append(_slots(store[p:p + 1], g)[0, a:b, lo:lo + width])
            start += b - a
        full = (end - start) // g.spr
        if full:
            p = start // g.spr
            views.append(_slots(store[p:p + full], g)[:, :, lo:lo + width])
            start += full * g.spr
        if start < end:
            p = start // g.spr
            views.append(_slots(store[p:p + 1], g)[0, :end - start,
                                                   lo:lo + width])
        return views

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

    def _local_part(self, g: _Group, store: torch.Tensor, table_name: str,
                    lo: int, width: int) -> torch.Tensor:
        """This rank's rows of one table's columns (or slot lanes) [lo, lo
        + width) as a new [rows, width] tensor; [0, width] when it holds
        none."""
        _, n, s0 = self._owned(g, table_name)
        if n == 0:
            return store.new_zeros(0, width)
        return self._read_views(self._range_views(g, store, s0, n, lo, width),
                                width)

    def _canonical(self, g: _Group, part: torch.Tensor,
                   split_columns: bool) -> torch.Tensor:
        """A table's whole rows from every rank's ``part``: row-sharded
        parts in rank order; column-wise parts side by side where
        ``split_columns`` (a per-column array), else rank 0's (a row-wise
        one, equal on every rank); a replica's own."""
        if self.shard is None or g.sharding == DATA_PARALLEL:
            return part
        if g.sharding == COLUMN_WISE:
            if not split_columns:
                return part
            return torch.cat(self.shard.all_gather_list(part), dim=1)
        return self.shard.all_gather_var(part)[0]

    def extract_table(self, tables: Dict[str, torch.Tensor],
                      table_name: str) -> torch.Tensor:
        """One table in canonical [rows, dim] layout: a view into an
        unpacked group of one rank, a copy out of a packed one (its rows
        are no 2-D view) and out of a sharded one (gathered from every
        rank: every rank calls it). Write through ``write_table``."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        if self.shard is None and not g.packed:
            off, rows = g.offsets[table_name], self._specs[table_name].rows
            return tables[gk][off:off + rows]
        part = self._local_part(g, tables[gk], table_name, 0, g.local_dim)
        return self._canonical(g, part, True)

    @torch.no_grad()
    def write_table(self, tables: Dict[str, torch.Tensor], table_name: str,
                    values: torch.Tensor) -> None:
        """Write a whole table, canonical [rows, dim], into its group's
        storage in place, under any layout (each rank writes the rows and
        columns it holds; no collective). In-row optimizer state is left
        as it is."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        a, n, s0 = self._owned(g, table_name)
        if n == 0:
            return
        vals = values[a:a + n, g.col_lo:g.col_lo + g.local_dim]
        self._fill_views(
            self._range_views(g, tables[gk], s0, n, 0, g.local_dim),
            vals.to(tables[gk]))

    @torch.no_grad()
    def read_rows(self, tables: Dict[str, torch.Tensor], table_name: str,
                  rows: torch.Tensor) -> torch.Tensor:
        """[len(rows), dim] canonical rows of one table, fp32, whatever the
        layout: each rank fills the rows it holds and the parts are
        summed over the ranks (collective under a ShardContext)."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        store = tables[gk]
        a, n, s0 = self._owned(g, table_name)
        rows = rows.long().to(store.device)
        mine = (rows >= a) & (rows < a + n)
        local = torch.where(mine, rows - a + s0, rows.new_full((), -1))
        part = self._gather(g, store, local).float()
        if self.shard is None or g.sharding == DATA_PARALLEL:
            return part
        if g.sharding == COLUMN_WISE:
            return torch.cat(self.shard.all_gather_list(part), dim=1)
        return self.shard.all_reduce(part)

    @torch.no_grad()
    def read_row_state(self, tables: Dict[str, torch.Tensor],
                       opt_state: Dict[str, Any], table_name: str,
                       rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{name: [len(rows), width]} canonical row state of one table at
        ``rows``, fp32, whatever the layout (``read_rows``' counterpart
        for the optimizer's row state; collective under a
        ShardContext)."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        store = tables[gk]
        a, n, s0 = self._owned(g, table_name)
        rows = rows.long().to(store.device)
        mine = (rows >= a) & (rows < a + n)
        local = torch.where(mine, rows - a + s0, rows.new_zeros(()))
        if g.packed:
            pid, lane, _ = self._packed_phys(g, local)
            _, arrays = self._split_slot(g, _slots(store, g)[pid, lane])
        else:
            st = (opt_state or {}).get(gk, {})
            arrays = {k: v[local] for k, v in st.items()
                      if v.dim() >= 1 and v.shape[0] == g.local_rows}
        out = {}
        for k, v in arrays.items():
            v = v.float().reshape(rows.shape[0], -1)
            v = torch.where(mine[:, None], v, v.new_zeros(()))
            if self.shard is None or g.sharding == DATA_PARALLEL:
                out[k] = v
            elif g.sharding == COLUMN_WISE:
                # a row-wise value is equal on every rank (its reduction
                # is all-reduced)
                out[k] = (torch.cat(self.shard.all_gather_list(v), dim=1)
                          if k in self._per_dim_state() else v)
            else:
                out[k] = self.shard.all_reduce(v)
        return out

    def _state_arrays(self, g: _Group, store, st, table_name):
        """{name: this rank's rows of each row-state array of one table}."""
        if g.packed:
            return {name: self._local_part(g, store, table_name, lo, width)
                    for name, lo, width in self._state_lanes(g)}
        _, n, s0 = self._owned(g, table_name)
        return {k: v[s0:s0 + n] for k, v in st.items()
                if v.dim() >= 1 and v.shape[0] == g.local_rows}

    def extract_table_state(self, tables: Dict[str, torch.Tensor],
                            opt_state: Dict[str, Any],
                            table_name: str) -> Dict[str, Any]:
        """Per-table optimizer state, whatever the layout: the table's
        rows of every row-state array (out of the rows of a packed
        group, out of ``opt_state`` otherwise; gathered from every rank
        under a ShardContext) and the group's scalars as they are."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        st = (opt_state or {}).get(gk, {})
        arrays = self._state_arrays(g, tables[gk], st, table_name)
        per_dim = self._per_dim_state()
        out: Dict[str, Any] = {k: self._canonical(g, v, k in per_dim)
                               for k, v in arrays.items()}
        out.update({k: v for k, v in st.items() if k not in arrays
                    and not (v.dim() >= 1 and v.shape[0] == g.local_rows)})
        return out

    def _per_dim_state(self) -> set:
        """Names of the row-state arrays with one column per weight column
        (the others hold one value a row)."""
        return {n for n, w in self.optimizer.row_state_widths(2) if w == 2}

    @torch.no_grad()
    def write_table_state(self, tables: Dict[str, torch.Tensor],
                          opt_state: Dict[str, Any], table_name: str,
                          table_state: Dict[str, Any]) -> None:
        """Inverse of ``extract_table_state``: row state goes into the
        table's rows (packed) or its slice of ``opt_state`` (unpacked),
        in place, each rank its own rows and columns; scalars replace the
        group's."""
        gk = self._table_group[table_name]
        g = self.groups[gk]
        a, n, s0 = self._owned(g, table_name)
        rows = self._specs[table_name].rows
        lanes = {name: (lo, width) for name, lo, width in self._state_lanes(g)}
        for key, val in table_state.items():
            val = torch.as_tensor(val)
            cur = opt_state[gk].get(key)
            if (g.packed and key in lanes) or (
                    cur is not None and cur.dim() >= 1):
                val = val.reshape(rows, -1)
                if key in self._per_dim_state():
                    val = val[:, g.col_lo:g.col_lo + g.local_dim]
                if n == 0:
                    continue
                val = val[a:a + n]
                if g.packed and key in lanes:
                    lo, width = lanes[key]
                    self._fill_views(
                        self._range_views(g, tables[gk], s0, n, lo, width),
                        val.to(tables[gk]))
                else:
                    cur[s0:s0 + n] = val.to(cur)
            else:
                opt_state[gk][key] = val.to(tables[gk].device)

"""In-process samplers.

Counterpart of torcheasyrec_tpu/datasets/sampler.py (``AliasTable``,
``BaseSampler`` and its registry, ``NegativeSampler``,
``NegativeSamplerV2``, ``HardNegativeSampler``, ``HardNegativeSamplerV2``,
``TDMSampler``, ``TDMPredictSampler``), with the same numpy and pyarrow
code and the same generator (``np.random.default_rng(0)``) drawn in the
same order, so both packages draw the same negatives from the same files
and batches.

A negative sampler takes a batch's Arrow columns and appends the sampled
items' attributes to the item-side columns named by ``attr_fields``: the
parser then reads those features (``NEG_DATA_GROUP``) at B + num_sample
rows, the batch's positives first and the shared negatives after, while
the user-side features keep B rows. The TDM sampler instead expands each
row into one row per (row, tree node) pair.

A sampler's tables (the item table, the edge CSRs, TDM's tree) are flat
numpy arrays. ``prepare_shared`` builds them once and publishes them in
one shared-memory segment (``utils/shm_pack.py``); a pickled copy of the
sampler (a loader worker's) carries the segment's name only and attaches
to it in ``init``. ``close_shared`` unlinks it.
"""

import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa

from torcheasyrec_tpu_torch.datasets.utils import (
    HARD_NEG_INDICES,
    pa_from_numpy,
)
from torcheasyrec_tpu_torch.utils import shm_pack
from torcheasyrec_tpu_torch.utils.load_class import get_register_class_meta

_SAMPLER_CLASS_MAP: Dict[str, type] = {}
_meta = get_register_class_meta(_SAMPLER_CLASS_MAP)


class AliasTable:
    """Walker's alias method: O(1) weighted draws after an O(n) build."""

    def __init__(self, weights: np.ndarray) -> None:
        w = np.asarray(weights, dtype=np.float64)
        w = np.where(w > 0, w, 0.0)
        n = len(w)
        prob_in = w * n / max(w.sum(), 1e-12)
        prob = np.ones(n)
        alias = np.arange(n, dtype=np.int64)
        small = np.flatnonzero(prob_in < 1.0).tolist()
        large = np.flatnonzero(prob_in >= 1.0).tolist()
        p = prob_in.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            prob[s] = p[s]
            alias[s] = l
            p[l] = p[l] - (1.0 - p[s])
            (small if p[l] < 1.0 else large).append(l)
        self._install(prob, alias)

    @classmethod
    def from_arrays(cls, prob: np.ndarray, alias: np.ndarray) -> "AliasTable":
        obj = cls.__new__(cls)
        obj._install(prob, alias)
        return obj

    def _install(self, prob: np.ndarray, alias: np.ndarray) -> None:
        self._prob = prob
        self._alias = alias
        self._n = len(prob)

    def sample(self, k: int, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, self._n, size=k)
        accept = rng.random(k) < self._prob[idx]
        return np.where(accept, idx, self._alias[idx])


def _read_table(path: str) -> pa.Table:
    import pyarrow.parquet as pq

    if path.endswith(".csv"):
        import pyarrow.csv as pacsv

        return pacsv.read_csv(path)
    return pq.read_table(path)


def _item_arrays(path: str, with_attrs: bool) -> Dict[str, np.ndarray]:
    """The item file (id | weight | attrs) as flat numpy arrays: ids and
    weights, the alias table, a sorted-id index, and (``with_attrs``) the
    attrs column as offsets and utf-8 bytes, decoded per sampled row."""
    tbl = _read_table(path)
    names = tbl.schema.names
    ids = tbl.column(0).to_numpy(zero_copy_only=False).astype(np.int64)
    weights = (
        tbl.column(1).to_numpy(zero_copy_only=False).astype(np.float64)
        if len(names) > 1
        else np.ones(len(ids))
    )
    alias = AliasTable(weights)
    order = np.argsort(ids, kind="stable")
    arrs = {"ids": ids, "weights": weights, "alias_prob": alias._prob,
            "alias_alias": alias._alias,
            "rows_sorted": order.astype(np.int64), "ids_sorted": ids[order]}
    if len(names) > 2 and with_attrs:
        col = tbl.column(2).cast(pa.large_string()).combine_chunks()
        arrs["attr_offsets"] = np.asarray(
            col.buffers()[1], dtype=np.uint8
        ).view(np.int64)[col.offset : col.offset + len(col) + 1].copy()
        data = col.buffers()[2]
        arrs["attr_bytes"] = (np.asarray(data, dtype=np.uint8).copy()
                              if data is not None else np.zeros(0, np.uint8))
    return arrs


def _edges(path: str):
    """The first two columns of an edge file as int64 arrays."""
    edges = _read_table(path)
    return tuple(edges.column(i).to_numpy(zero_copy_only=False)
                 .astype(np.int64) for i in (0, 1))


def _csr(keys: np.ndarray, vals: np.ndarray, prefix: str
         ) -> Dict[str, np.ndarray]:
    """(key, value) pairs -> CSR arrays: the distinct keys (sorted)
    ``<prefix>_users``, their offsets [U + 1] ``<prefix>_offs`` and the
    values ``<prefix>_items``, each key's in file order."""
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    users, starts = np.unique(keys, return_index=True)
    offs = np.concatenate([starts, [keys.size]]).astype(np.int64)
    return {f"{prefix}_users": users, f"{prefix}_offs": offs,
            f"{prefix}_items": vals}


def _csr_get(arrs: Dict[str, np.ndarray], prefix: str,
             key: int) -> np.ndarray:
    users = arrs[f"{prefix}_users"]
    p = int(np.searchsorted(users, key))
    if p >= users.size or users[p] != key:
        return np.zeros(0, np.int64)
    offs = arrs[f"{prefix}_offs"]
    return arrs[f"{prefix}_items"][offs[p] : offs[p + 1]]


class BaseSampler(metaclass=_meta):
    """Base of the samplers: the config, the generator and the tables;
    subclasses add their own arrays (``_extra_arrays``) and implement
    ``process``. Outside train mode ``num_eval_sample`` (where set)
    replaces ``num_sample``. In sequence mode (``seq_delim`` set:
    ``item_id_field`` names a grouped sequence's sub-feature), a row of
    the item id column holds its positives joined by ``seq_delim``."""

    def __init__(self, config: Any, is_training: bool = True,
                 seq_delim: Optional[str] = None) -> None:
        self._config = config
        self._num_sample = int(getattr(config, "num_sample", 0))
        if not is_training and getattr(config, "num_eval_sample", 0):
            self._num_sample = int(config.num_eval_sample)
        self._attr_fields = list(config.attr_fields)
        self._attr_delim = getattr(config, "attr_delimiter", ":") or ":"
        self._item_id_field = config.item_id_field
        self._seq_delim = seq_delim
        self._rng = np.random.default_rng(0)
        self._inited = False
        self._shm_name: Optional[str] = None
        self._tables: Dict[str, np.ndarray] = {}

    def init(self) -> None:
        """Builds the tables from the files, or attaches to the shared
        segment where ``prepare_shared`` published them."""
        if not self._inited:
            self._install(shm_pack.attach(self._shm_name) if self._shm_name
                          else self._build_arrays())
            self._inited = True

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        raise NotImplementedError

    # -- the tables --------------------------------------------------------

    def _item_table_path(self) -> str:
        return (getattr(self._config, "item_input_path", "")
                or self._config.input_path)

    def _build_arrays(self) -> Dict[str, np.ndarray]:
        arrs = _item_arrays(self._item_table_path(), bool(self._attr_fields))
        arrs.update(self._extra_arrays(arrs))
        return arrs

    def _extra_arrays(self, items: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """The subclass's arrays beside the item table (``items``)."""
        return {}

    def _install(self, arrs: Dict[str, np.ndarray]) -> None:
        self._tables = arrs
        self._item_ids = arrs["ids"]
        self._item_weights = arrs["weights"]
        self._alias = AliasTable.from_arrays(arrs["alias_prob"],
                                             arrs["alias_alias"])
        self._rows_sorted = arrs["rows_sorted"]
        self._ids_sorted = arrs["ids_sorted"]
        self._attr_offsets = arrs.get("attr_offsets")
        self._attr_bytes = arrs.get("attr_bytes")

    def prepare_shared(self) -> None:
        """Builds the tables once, here, and publishes them in one
        shared-memory segment; this sampler and its pickled copies read
        them from it. Call ``close_shared`` when its users are done."""
        if self._shm_name:
            return
        name = f"tzrec_torch_items_{uuid.uuid4().hex[:12]}"
        views = shm_pack.build(name, self._build_arrays())
        self._shm_name = name
        self._install(views)
        self._inited = True

    def close_shared(self) -> None:
        """Unlinks the shared segment. The tables are dropped here; a later
        ``init`` builds them again from the files."""
        name, self._shm_name = self._shm_name, None
        if name:
            self._drop_tables()
            shm_pack.unlink(name)

    # the attributes ``_install`` sets: a shared copy drops them
    _TABLE_ATTRS = ("_item_ids", "_item_weights", "_alias", "_rows_sorted",
                    "_ids_sorted", "_attr_offsets", "_attr_bytes")

    def _drop_tables(self) -> None:
        for k in self._TABLE_ATTRS:
            self.__dict__.pop(k, None)
        self._tables = {}
        self._inited = False

    def __getstate__(self):
        """A copy for a loader worker: once the tables are shared it
        carries the segment's name only, and attaches in ``init``."""
        state = dict(self.__dict__)
        if self._shm_name:
            for k in self._TABLE_ATTRS:
                state.pop(k, None)
            state["_tables"] = {}
            state["_inited"] = False
        return state

    # -- shared helpers -----------------------------------------------------

    def _pos_id_set(self, columns: Dict[str, pa.Array]) -> set:
        """Distinct positive item ids of the batch, multi-positive rows
        flattened (list columns, or strings joined by ``seq_delim``)."""
        col = columns.get(self._item_id_field)
        if col is None:
            return set()
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            return set(col.flatten().cast(pa.int64(), safe=False).to_pylist())
        if self._seq_delim and pa.types.is_string(col.type):
            out = set()
            for s in col.to_pylist():
                for tok in (s.split(self._seq_delim) if s else ()):
                    try:
                        out.add(int(float(tok)))
                    except ValueError:
                        continue
            return out
        try:
            return set(col.cast(pa.int64(), safe=False).to_pylist())
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            out = set()
            for s in col.cast(pa.string()).to_pylist():
                try:
                    out.add(int(float(s)))
                except (TypeError, ValueError):
                    continue
            return out

    # -- item-table lookups ------------------------------------------------

    def _rows_of(self, ids: np.ndarray) -> np.ndarray:
        """Item ids -> row indices (-1 for an unknown id)."""
        ids = np.asarray(ids, np.int64)
        if len(self._ids_sorted) == 0:
            return np.full(ids.shape, -1, np.int64)
        pos = np.searchsorted(self._ids_sorted, ids)
        pos = np.clip(pos, 0, len(self._ids_sorted) - 1)
        ok = self._ids_sorted[pos] == ids
        return np.where(ok, self._rows_sorted[pos], -1)

    @property
    def _has_attrs(self) -> bool:
        return self._attr_offsets is not None and len(self._attr_offsets) > 1

    def _attr_vals(self, row: int) -> List[str]:
        o = self._attr_offsets
        s = bytes(self._attr_bytes[o[row] : o[row + 1]]).decode(
            "utf-8", "replace"
        )
        return s.split(self._attr_delim)

    def _append_negatives(
        self, columns: Dict[str, pa.Array], rows: np.ndarray
    ) -> Dict[str, pa.Array]:
        """The columns with the sampled item rows' attributes appended to
        the item-side ones (positives first, then the negatives)."""
        out = dict(columns)
        neg_vals: Dict[str, List[str]] = {
            name: [] for name in self._attr_fields
        }
        if self._has_attrs:
            for r in rows:
                vals = self._attr_vals(int(r))
                for j, name in enumerate(self._attr_fields):
                    neg_vals[name].append(vals[j] if j < len(vals) else "")
        else:
            neg_vals = {self._item_id_field: [str(self._item_ids[r])
                                              for r in rows]}
        for name, vals in neg_vals.items():
            if name not in columns:
                continue
            col = columns[name]
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            neg_arr = pa.array(vals, type=pa.string())
            try:
                neg_arr = neg_arr.cast(col.type)
            except pa.ArrowInvalid:
                col = col.cast(pa.string())
            out[name] = pa.concat_arrays([col, neg_arr])
        return out

    def _resample_banned(self, rows: np.ndarray, banned) -> np.ndarray:
        """Draws again, twice at most, the rows whose item id is in
        ``banned`` (a set or a sorted array)."""
        for _ in range(2):
            if isinstance(banned, set):
                bad = np.asarray([int(self._item_ids[r]) in banned
                                  for r in rows], dtype=bool)
            else:
                bad = np.isin(self._item_ids[rows], banned)
            if not bad.any():
                break
            rows[bad] = self._alias.sample(int(bad.sum()), self._rng)
        return rows


class NegativeSampler(BaseSampler):
    """Weighted random negatives shared by the batch, the batch's positive
    ids drawn again (twice at most)."""

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        self.init()
        rows = self._alias.sample(self._num_sample, self._rng)
        if self._item_id_field in columns:
            rows = self._resample_banned(rows, self._pos_id_set(columns))
        return self._append_negatives(columns, rows)


_NO_EDGES = {"pe_users": np.zeros(0, np.int64),
             "pe_offs": np.zeros(1, np.int64),
             "pe_items": np.zeros(0, np.int64)}


class NegativeSamplerV2(BaseSampler):
    """Negatives that are none of the batch users' positive edges: drawn
    again twice, then from the weights with those items taken out. The
    positive edges are a CSR beside the item table (``pe_*``)."""

    def __init__(self, config: Any, is_training: bool = True,
                 seq_delim: Optional[str] = None) -> None:
        super().__init__(config, is_training, seq_delim)
        self._user_id_field = config.user_id_field

    def _item_table_path(self) -> str:
        return self._config.item_input_path

    def _extra_arrays(self, items):
        path = getattr(self._config, "pos_edge_input_path", "")
        return _csr(*_edges(path), "pe") if path else dict(_NO_EDGES)

    def _users(self, columns: Dict[str, pa.Array]) -> Optional[np.ndarray]:
        if self._user_id_field not in columns:
            return None
        return (columns[self._user_id_field].cast(pa.int64(), safe=False)
                .to_numpy(zero_copy_only=False))

    def _banned_for(self, users) -> np.ndarray:
        """Distinct positive-edge item ids of the given users (sorted)."""
        pe_users = self._tables["pe_users"]
        if not len(users) or pe_users.size == 0:
            return np.zeros(0, np.int64)
        uu = np.unique(np.asarray(users, np.int64))
        pos = np.searchsorted(pe_users, uu)
        pos = pos[(pos < pe_users.size)
                  & (pe_users[np.minimum(pos, pe_users.size - 1)] == uu)]
        if not pos.size:
            return np.zeros(0, np.int64)
        offs, items = self._tables["pe_offs"], self._tables["pe_items"]
        return np.unique(np.concatenate(
            [items[offs[p] : offs[p + 1]] for p in pos]))

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        self.init()
        rows = self._alias.sample(self._num_sample, self._rng)
        users = self._users(columns)
        if users is not None:
            banned = self._banned_for(users)
            rows = self._resample_banned(rows, banned)
            bad = np.isin(self._item_ids[rows], banned)
            if bad.any():
                # the exclusion is exact: draw the rest from the weights
                # with the banned items taken out
                w = self._item_weights * ~np.isin(self._item_ids, banned)
                if w.sum() > 0:
                    rows[bad] = self._rng.choice(
                        len(self._item_ids), size=int(bad.sum()),
                        p=w / w.sum(),
                    )
        return self._append_negatives(columns, rows)


class HardNegativeSampler(NegativeSamplerV2):
    """Shared random negatives (without the batch users' positive edges,
    where a positive-edge file is given) plus per-user hard negatives from
    a (user, item) edge file, a second CSR (``he_*``).

    Item rows come out as ``[B positives | num_sample shared negatives |
    B * num_hard_sample hard slots]``, the hard block always of that size
    (an empty slot repeats item row 0). ``HARD_NEG_INDICES`` carries the
    int32 [B * num_hard_sample, 2] (user row, hard column) pairs; an empty
    slot's user row is B, which the model's scatter drops."""

    def __init__(self, config: Any, is_training: bool = True,
                 seq_delim: Optional[str] = None) -> None:
        super().__init__(config, is_training, seq_delim)
        self._num_hard = int(config.num_hard_sample)

    def _extra_arrays(self, items):
        arrs = NegativeSamplerV2._extra_arrays(self, items)
        arrs.update(_csr(*_edges(self._config.hard_neg_edge_input_path),
                         "he"))
        return arrs

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        self.init()
        rows = list(self._alias.sample(self._num_sample, self._rng))
        users = self._users(columns)
        if users is not None and self._tables["pe_users"].size:
            rows = list(self._resample_banned(
                np.asarray(rows, dtype=np.int64), self._banned_for(users)))
        b = len(next(iter(columns.values())))
        k = self._num_hard
        indices = np.empty((b * k, 2), dtype=np.int32)
        indices[:, 0] = b  # an empty slot: dropped by the model's scatter
        indices[:, 1] = 0
        for i in range(b):
            cands = (
                _csr_get(self._tables, "he", int(users[i]))
                if users is not None
                else np.zeros(0, np.int64)
            )
            crows = self._rows_of(np.asarray(cands, np.int64))
            crows = crows[crows >= 0]
            take = (
                self._rng.choice(
                    crows, size=min(k, len(crows)), replace=False
                )
                if len(crows)
                else []
            )
            for j in range(k):
                if j < len(take):
                    rows.append(int(take[j]))
                    indices[i * k + j] = (i, j)
                else:
                    rows.append(0)  # an empty slot keeps the shape
        out = self._append_negatives(
            columns, np.asarray(rows, dtype=np.int64)
        )
        out[HARD_NEG_INDICES] = indices
        return out


class HardNegativeSamplerV2(HardNegativeSampler):
    """``HardNegativeSampler`` whose config names a positive-edge file:
    the shared negatives avoid the batch users' positive edges."""


def _tree_arrays(items: Dict[str, np.ndarray], edge_path: str
                 ) -> Dict[str, np.ndarray]:
    """A tree's (parent, child) edge file over the node table ``items``
    -> per node row its parent's row (-1 at a root) and its depth (root
    0), and the nodes of each depth (``layer_nodes``, node-table order
    within a depth; depth d's at ``layer_offs[d]:layer_offs[d + 1]``).
    Every node an edge names must be in the node table."""
    ids = items["ids"]
    src, dst = _edges(edge_path)
    order, sorted_ids = items["rows_sorted"], items["ids_sorted"]

    def rows(x):
        pos = np.clip(np.searchsorted(sorted_ids, x), 0,
                      max(len(sorted_ids) - 1, 0))
        if len(x) and (len(sorted_ids) == 0
                       or not (sorted_ids[pos] == x).all()):
            raise ValueError(f"{edge_path}: an edge names a node that is "
                             "not in the node table")
        return order[pos]

    parent = np.full(len(ids), -1, np.int64)
    parent[rows(dst)] = rows(src)
    depth = np.zeros(len(ids), np.int64)
    up = parent.copy()
    for _ in range(len(ids) + 1):
        live = up >= 0
        if not live.any():
            break
        depth[live] += 1
        up[live] = parent[up[live]]
    else:
        raise ValueError(f"{edge_path}: the edges hold a cycle")
    by_depth = np.argsort(depth, kind="stable")
    counts = np.bincount(depth, minlength=1)
    return {"tree_parent": parent, "tree_depth": depth,
            "layer_nodes": ids[by_depth],
            "layer_offs": np.concatenate([[0], np.cumsum(counts)])
            .astype(np.int64)}


class TDMSampler(BaseSampler):
    """The tree sampler: every row expands into, for each of its item's
    tree ancestors (the leaf itself up to the root), one positive row and
    ``layer_num_sample[depth]`` negatives drawn uniformly from the nodes
    of that depth (depth counted from the root; a negative equal to the
    positive is dropped, so the row count varies from batch to batch).
    User-side columns are repeated; the item id column and the other attr
    columns are overwritten with the nodes', the first label field with
    1 / 0. The node table is the item table; the tree (``tree_*``,
    ``layer_*``) lies beside it."""

    _TABLE_ATTRS = BaseSampler._TABLE_ATTRS + ("_max_depth", "_layer_nodes")

    def __init__(self, config: Any, is_training: bool = True,
                 label_field: str = "label",
                 seq_delim: Optional[str] = None) -> None:
        super().__init__(config, is_training, seq_delim)
        self._label_field = label_field
        self._layer_num_sample = list(config.layer_num_sample)

    def _item_table_path(self) -> str:
        return self._config.item_input_path

    def _extra_arrays(self, items):
        return _tree_arrays(items, self._config.edge_input_path)

    def _install(self, arrs: Dict[str, np.ndarray]) -> None:
        super()._install(arrs)
        self._max_depth = (int(arrs["tree_depth"].max())
                           if arrs["tree_depth"].size else 0)
        offs, nodes = arrs["layer_offs"], arrs["layer_nodes"]
        self._layer_nodes = {d: nodes[offs[d] : offs[d + 1]]
                             for d in range(len(offs) - 1)
                             if offs[d + 1] > offs[d]}

    def _neg_count(self, depth: int) -> int:
        lns = self._layer_num_sample
        if depth < len(lns):
            return lns[depth]
        return lns[-1] if lns else 1

    def _ancestor_table(self, items: List[Optional[int]]):
        """(nodes, depths) per row: the row's item and its ancestors, leaf
        to root, with their depths (an item outside the node table counts
        as a root of depth 0)."""
        parent = self._tables["tree_parent"]
        depth = self._tables["tree_depth"]
        cur = self._rows_of(np.asarray(
            [0 if it is None else it for it in items], np.int64))
        chain = [cur]
        while True:
            cur = np.where(cur >= 0, parent[np.maximum(cur, 0)], -1)
            if not (cur >= 0).any():
                break
            chain.append(cur)
        chain = np.stack(chain, axis=1)
        safe = np.maximum(chain, 0)
        nodes = np.where(chain >= 0, self._item_ids[safe], -1)
        nodes[:, 0] = [0 if it is None else it for it in items]
        depths = np.where(chain >= 0, depth[safe], 0)
        lengths = 1 + (chain[:, 1:] >= 0).sum(axis=1)
        return [(n[:k], d[:k]) for n, d, k in zip(
            nodes.tolist(), depths.tolist(), lengths.tolist())]

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        self.init()
        items = (columns[self._item_id_field].cast(pa.int64(), safe=False)
                 .to_pylist())
        rep_idx: List[int] = []
        out_nodes: List[int] = []
        out_labels: List[float] = []
        for i, (nodes, depths) in enumerate(self._ancestor_table(items)):
            for node, depth in zip(nodes, depths):
                neg_cnt = self._neg_count(depth)
                pool = self._layer_nodes.get(depth)
                if depth == 0 and neg_cnt == 0 and (pool is None
                                                    or len(pool) <= 1):
                    continue  # the root: no row of its own
                rep_idx.append(i)
                out_nodes.append(node)
                out_labels.append(1.0)
                if pool is None or len(pool) <= 1 or neg_cnt <= 0:
                    continue
                for ng in self._rng.choice(pool, size=neg_cnt):
                    if int(ng) == node:
                        continue
                    rep_idx.append(i)
                    out_nodes.append(int(ng))
                    out_labels.append(0.0)
        rep = pa_from_numpy(np.asarray(rep_idx, np.int64))
        out: Dict[str, pa.Array] = {}
        for name, col in columns.items():
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            out[name] = col.take(rep)
        node_arr = np.asarray(out_nodes, np.int64)
        out[self._item_id_field] = pa_from_numpy(node_arr)
        attr_cols = [(j, f) for j, f in enumerate(self._attr_fields)
                     if f != self._item_id_field and f in columns]
        if self._has_attrs and attr_cols:
            decoded = [self._attr_vals(int(r)) if r >= 0 else []
                       for r in self._rows_of(node_arr)]
            for j, fname in attr_cols:
                vals = [a[j] if j < len(a) else "" for a in decoded]
                try:
                    out[fname] = pa.array(vals).cast(columns[fname].type)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                    out[fname] = pa.array(vals)
        out[self._label_field] = pa.array(np.asarray(out_labels, np.float32))
        return out


class TDMPredictSampler(BaseSampler):
    """The tree's child expansion for retrieval: up to ``expand_factor``
    children per node (drawn without replacement where a node has more),
    from the predict edge file (else the training one), as a CSR of
    children by parent (``ch_*``) beside the node table; and the nodes'
    attr columns."""

    def __init__(self, config: Any, is_training: bool = False,
                 seq_delim: Optional[str] = None) -> None:
        super().__init__(config, is_training, seq_delim)
        self._expand_factor = 0

    def _item_table_path(self) -> str:
        return self._config.item_input_path

    def _extra_arrays(self, items):
        path = (getattr(self._config, "predict_edge_input_path", "")
                or self._config.edge_input_path)
        return _csr(*_edges(path), "ch")

    def init_sampler(self, expand_factor: int) -> None:
        """Sets how many children each node expands into."""
        self.init()
        self._expand_factor = int(expand_factor)

    def get_children_ids(self, ids: np.ndarray) -> np.ndarray:
        """[n] node ids -> [n, expand_factor] child ids, -1 padded; a pad
        id (< 0) gives a row of pads."""
        self.init()
        k = self._expand_factor
        out = np.full((len(ids), k), -1, np.int64)
        for i, nid in enumerate(np.asarray(ids, np.int64)):
            if nid < 0:
                continue
            ch = _csr_get(self._tables, "ch", int(nid))
            if len(ch) > k:
                ch = self._rng.choice(ch, size=k, replace=False)
            out[i, : len(ch)] = ch
        return out

    def get(self, input_data: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        """A batch of node ids -> the children's attr columns, flattened
        ([n * expand_factor] rows; a pad child gives empty strings)."""
        col = input_data[self._item_id_field]
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        ids = col.cast(pa.int64(), safe=False).to_numpy(zero_copy_only=False)
        return self.node_attr_columns(self.get_children_ids(ids).reshape(-1))

    def node_attr_columns(self, node_ids: np.ndarray) -> Dict[str, pa.Array]:
        """Flat node ids -> item-side attr columns (a pad id -1 -> '')."""
        self.init()
        names = self._attr_fields
        cols: Dict[str, List[str]] = {name: [] for name in names}
        node_ids = np.asarray(node_ids, np.int64)
        for nid, row in zip(node_ids, self._rows_of(node_ids)):
            vals = (self._attr_vals(int(row))
                    if (self._has_attrs and row >= 0)
                    else ([str(nid)] if nid >= 0 else [""]))
            for j, name in enumerate(names):
                cols[name].append(vals[j] if j < len(vals) else "")
        return {k: pa.array(v, type=pa.string()) for k, v in cols.items()}

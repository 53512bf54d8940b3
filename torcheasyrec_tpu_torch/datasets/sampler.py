"""In-process negative samplers.

Counterpart of torcheasyrec_tpu/datasets/sampler.py (``AliasTable``,
``BaseSampler`` and its registry, ``NegativeSampler``,
``NegativeSamplerV2``, ``HardNegativeSampler``, ``HardNegativeSamplerV2``),
with the same numpy and pyarrow code and the same generator
(``np.random.default_rng(0)``), so both packages draw the same negatives
from the same files and batches.

A sampler takes a batch's Arrow columns and appends the sampled items'
attributes to the item-side columns named by ``attr_fields``: the parser
then reads those features (``NEG_DATA_GROUP``) at B + num_sample rows,
the batch's positives first and the shared negatives after, while the
user-side features keep B rows.

The JAX package publishes the item table once per host in shared memory
(``prepare_shared``, ``close_shared``, ``shm_pack``) for its loader's
worker processes. This port does not: a ``DataLoader`` worker takes a
pickled copy of the sampler and, where the parent has not loaded it yet,
reads the files itself. The copy costs about 40 bytes of numpy arrays per
item and edge plus the attribute strings; at the 2 000-item table of the
criteo_synth data that is under 0.2 MB a worker, and it starts to matter
at tens of millions of items (about 1 GB a worker at 20 M items). The
TDM samplers are not ported.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa

from torcheasyrec_tpu_torch.datasets.utils import HARD_NEG_INDICES
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
        self._prob = prob
        self._alias = alias
        self._n = n

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


class BaseSampler(metaclass=_meta):
    """Base of the samplers: the config, the generator and the item table;
    subclasses implement ``_load`` and ``process``. Outside train mode
    ``num_eval_sample`` (where set) replaces ``num_sample``. In sequence
    mode (``seq_delim`` set: ``item_id_field`` names a grouped sequence's
    sub-feature), a row of the item id column holds its positives joined
    by ``seq_delim``."""

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

    def init(self) -> None:
        if not self._inited:
            self._load()
            self._inited = True

    def _load(self) -> None:
        raise NotImplementedError

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        raise NotImplementedError

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

    def _load_item_table(self, path: str) -> None:
        """The item file (id | weight | attrs) as flat numpy arrays: ids
        and weights, the alias table, a sorted-id index, and the attrs
        column as offsets and utf-8 bytes, decoded per sampled row."""
        tbl = _read_table(path)
        names = tbl.schema.names
        ids = tbl.column(0).to_numpy(zero_copy_only=False).astype(np.int64)
        weights = (
            tbl.column(1).to_numpy(zero_copy_only=False).astype(np.float64)
            if len(names) > 1
            else np.ones(len(ids))
        )
        self._item_ids = ids
        self._item_weights = weights
        self._alias = AliasTable(weights)
        order = np.argsort(ids, kind="stable")
        self._rows_sorted = order.astype(np.int64)
        self._ids_sorted = ids[order]
        self._attr_offsets = self._attr_bytes = None
        if len(names) > 2 and self._attr_fields:
            col = tbl.column(2).cast(pa.large_string()).combine_chunks()
            self._attr_offsets = np.asarray(
                col.buffers()[1], dtype=np.uint8
            ).view(np.int64)[col.offset : col.offset + len(col) + 1].copy()
            data = col.buffers()[2]
            self._attr_bytes = (
                np.asarray(data, dtype=np.uint8).copy()
                if data is not None else np.zeros(0, np.uint8)
            )

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

    def _load(self) -> None:
        self._load_item_table(self._config.input_path)

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        self.init()
        rows = self._alias.sample(self._num_sample, self._rng)
        if self._item_id_field in columns:
            rows = self._resample_banned(rows, self._pos_id_set(columns))
        return self._append_negatives(columns, rows)


def _edges_to_csr(path: str) -> Dict[str, np.ndarray]:
    """A (user, item) edge file -> CSR arrays: the distinct users
    (sorted), their offsets [U + 1] and the items [E]."""
    edges = _read_table(path)
    u = edges.column(0).to_numpy(zero_copy_only=False).astype(np.int64)
    i = edges.column(1).to_numpy(zero_copy_only=False).astype(np.int64)
    order = np.argsort(u, kind="stable")
    u, i = u[order], i[order]
    users, starts = np.unique(u, return_index=True)
    offs = np.concatenate([starts, [u.size]]).astype(np.int64)
    return {"users": users, "offs": offs, "items": i}


_NO_EDGES = {"users": np.zeros(0, np.int64), "offs": np.zeros(1, np.int64),
             "items": np.zeros(0, np.int64)}


class NegativeSamplerV2(BaseSampler):
    """Negatives that are none of the batch users' positive edges: drawn
    again twice, then from the weights with those items taken out."""

    def _load(self) -> None:
        self._load_item_table(self._config.item_input_path)
        path = getattr(self._config, "pos_edge_input_path", "")
        self._pos_edges = _edges_to_csr(path) if path else _NO_EDGES
        self._user_id_field = self._config.user_id_field

    def _users(self, columns: Dict[str, pa.Array]) -> Optional[np.ndarray]:
        if self._user_id_field not in columns:
            return None
        return (columns[self._user_id_field].cast(pa.int64(), safe=False)
                .to_numpy(zero_copy_only=False))

    def _banned_for(self, users) -> np.ndarray:
        """Distinct positive-edge item ids of the given users (sorted)."""
        pe = self._pos_edges
        if not len(users) or pe["users"].size == 0:
            return np.zeros(0, np.int64)
        uu = np.unique(np.asarray(users, np.int64))
        pos = np.searchsorted(pe["users"], uu)
        pos = pos[
            (pos < pe["users"].size)
            & (pe["users"][np.minimum(pos, pe["users"].size - 1)] == uu)
        ]
        if not pos.size:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(
            [pe["items"][pe["offs"][p] : pe["offs"][p + 1]] for p in pos]))

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
    a (user, item) edge file.

    Item rows come out as ``[B positives | num_sample shared negatives |
    B * num_hard_sample hard slots]``, the hard block always of that size
    (an empty slot repeats item row 0). ``HARD_NEG_INDICES`` carries the
    int32 [B * num_hard_sample, 2] (user row, hard column) pairs; an empty
    slot's user row is B, which the model's scatter drops."""

    def _load(self) -> None:
        NegativeSamplerV2._load(self)
        self._hard_edges = _edges_to_csr(
            self._config.hard_neg_edge_input_path)
        self._num_hard = int(self._config.num_hard_sample)

    def _hard_cands(self, user: int) -> np.ndarray:
        he = self._hard_edges
        p = int(np.searchsorted(he["users"], user))
        if p >= he["users"].size or he["users"][p] != user:
            return np.zeros(0, np.int64)
        return he["items"][he["offs"][p] : he["offs"][p + 1]]

    def process(self, columns: Dict[str, pa.Array]) -> Dict[str, pa.Array]:
        self.init()
        rows = list(self._alias.sample(self._num_sample, self._rng))
        users = self._users(columns)
        if users is not None and self._pos_edges["users"].size:
            rows = list(self._resample_banned(
                np.asarray(rows, dtype=np.int64), self._banned_for(users)))
        b = len(next(iter(columns.values())))
        k = self._num_hard
        indices = np.empty((b * k, 2), dtype=np.int32)
        indices[:, 0] = b  # an empty slot: dropped by the model's scatter
        indices[:, 1] = 0
        for i in range(b):
            cands = (
                self._hard_cands(int(users[i]))
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

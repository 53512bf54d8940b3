"""Host-memory spill tier behind the ZCH / dynamicemb device table.

Counterpart of torcheasyrec_tpu/parallel/host_spill.py, the same numpy
code (it runs on the host between steps and is never traced). An id
evicted from the device table keeps its trained vector here and gets it
back on readmission instead of a stale row.

Per train step (``main.make_train_step``):
  1. the remap returns each spill table's record (evicted keys, fresh
     keys, slots); the evicted keys' rows are gathered from the tables
     BEFORE the step's sparse update, so the stored vector is the key's
     last trained state;
  2. ``SpillManager.process`` stores the evicted rows under their raw
     keys (a bounded LRU) and pops the rows of fresh keys it holds;
  3. those restores are written into the device tables before the next
     step (``EmbeddingGroup.apply_spill_restores``): one-step-late
     readmission.

``HostSpillStore`` is a vectorised numpy open-addressing table (linear
probing over a power-of-2 capacity). Within one ``store`` a duplicate
key's last row wins; within one ``take`` a duplicate key's first
position wins; taken rows are removed (tombstones). ``state_dict`` and
``load_state_dict`` carry a store through a checkpoint, which the JAX
package does not (its resume starts the stores empty).

Over several ranks (``modules/embedding.py``) the mapping is replicated,
so every rank sees the same spill records. A store then keeps, beside
each key, its home: the table slot it was evicted from. Where the rows
of a table are sharded, rank r stores only the keys whose home row it
holds (``store(..., keep=)``), with the stamps and clock that one store
of the whole record would give, so that the ranks' stores are the parts
of a world-size-1 store; a checkpoint merges them, a restore splits them
again by the homes.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

_GOLD = np.uint64(0x9E3779B97F4A7C15)
# stamp = clock << _SUB_BITS | within-batch position: preserves the
# old OrderedDict's per-key LRU order inside one store() batch
_SUB_BITS = 22

_EMPTY = -1
_TOMB = -2


class HostSpillStore:
    """Bounded LRU host store: raw id -> last trained row vector."""

    def __init__(self, dim: int, max_items: int = 0) -> None:
        self.dim = int(dim)
        self.max_items = int(max_items)  # 0 = unbounded
        self.stored = 0  # lifetime counters (observability/tests)
        self.restored = 0
        self.dropped = 0
        self._size = 0
        self._tombs = 0
        self._clock = 0
        if max_items:
            cap = 64
            while cap < 2 * max_items:
                cap *= 2
        else:
            cap = 1024
        self._alloc(cap)

    def _alloc(self, cap: int) -> None:
        self._cap = cap
        self._log2cap = int(cap).bit_length() - 1
        self._k = np.full(cap, _EMPTY, np.int64)
        self._rows = np.zeros((cap, self.dim), np.float32)
        self._stamp = np.zeros(cap, np.int64)
        self._home = np.full(cap, -1, np.int64)
        self._tombs = 0

    def __len__(self) -> int:
        return self._size

    def _hash(self, q: np.ndarray) -> np.ndarray:
        h = q.astype(np.uint64) * _GOLD
        return (h >> np.uint64(64 - self._log2cap)).astype(np.int64)

    def _lookup(self, q: np.ndarray) -> np.ndarray:
        """Slot per key (or -1). Whole-batch probe rounds: each round
        resolves every pending key's current probe position at once."""
        mask = self._cap - 1
        res = np.full(q.size, -1, np.int64)
        cur = self._hash(q)
        pending = np.arange(q.size)[q >= 0]  # negatives never match
        for _ in range(self._cap):
            if not pending.size:
                break
            s = cur[pending]
            tk = self._k[s]
            hit = tk == q[pending]
            res[pending[hit]] = s[hit]
            stop = hit | (tk == _EMPTY)
            pending = pending[~stop]
            cur[pending] = (cur[pending] + 1) & mask
        return res

    def _rehash(self, newcap: int) -> None:
        occ = np.nonzero(self._k >= 0)[0]
        keys, rows, stamps, homes = (
            self._k[occ], self._rows[occ], self._stamp[occ], self._home[occ]
        )
        self._alloc(newcap)
        self._size = 0
        if keys.size:
            self._insert(keys, rows, stamps, homes)

    def _insert(self, q, rows, stamps, homes) -> None:
        """Insert UNIQUE keys (update-in-place on existing)."""
        slots = self._lookup(q)
        upd = slots >= 0
        if upd.any():
            s = slots[upd]
            self._rows[s] = rows[upd]
            self._stamp[s] = stamps[upd]
            self._home[s] = homes[upd]
        need = np.nonzero(~upd)[0]
        if not need.size:
            return
        while (self._size + need.size + self._tombs) * 2 > self._cap:
            self._rehash(self._cap * 2)
        mask = self._cap - 1
        cur = self._hash(q[need])
        pending = np.arange(need.size)
        for _ in range(self._cap):
            if not pending.size:
                break
            s = cur[pending]
            tk = self._k[s]
            free = tk < 0
            if free.any():
                cand = np.nonzero(free)[0]
                _, first = np.unique(s[cand], return_index=True)
                wpos = cand[first]  # one winner per contested slot
                wslots = s[wpos]
                self._tombs -= int((self._k[wslots] == _TOMB).sum())
                widx = need[pending[wpos]]
                self._k[wslots] = q[widx]
                self._rows[wslots] = rows[widx]
                self._stamp[wslots] = stamps[widx]
                self._home[wslots] = homes[widx]
                keep = np.ones(pending.size, bool)
                keep[wpos] = False
                pending = pending[keep]
            cur[pending] = (cur[pending] + 1) & mask
        self._size += need.size

    def __contains__(self, key: int) -> bool:
        return int(
            self._lookup(np.asarray([int(key)], np.int64))[0]
        ) >= 0

    def get(self, key: int) -> Optional[np.ndarray]:
        s = int(self._lookup(np.asarray([int(key)], np.int64))[0])
        return self._rows[s].copy() if s >= 0 else None

    def store(self, keys: np.ndarray, rows: np.ndarray,
              homes: Optional[np.ndarray] = None,
              keep: Optional[np.ndarray] = None) -> int:
        """Store rows[i] under keys[i] for keys[i] >= 0 (with ``homes[i]``,
        the slot it left, where given); returns count. With ``keep`` only
        the entries it marks are stored, with the stamps that storing all
        of them would give (a rank's part of a replicated record)."""
        keys = np.asarray(keys, np.int64).ravel()
        rows = np.asarray(rows, np.float32).reshape(keys.size, self.dim)
        homes = (np.full(keys.size, -1, np.int64) if homes is None
                 else np.asarray(homes, np.int64).ravel())
        valid = keys >= 0
        if not valid.any():
            return 0
        if keep is None:
            keep = np.ones(keys.size, bool)
        keep = np.asarray(keep, bool).ravel()[valid]
        q, r, h = keys[valid], rows[valid], homes[valid]
        n = int(keep.sum())
        # duplicate keys in one batch: LAST write wins (dict semantics)
        rev_first = np.unique(q[::-1], return_index=True)[1]
        sel = np.sort(q.size - 1 - rev_first)
        q, r, h, keep = q[sel], r[sel], h[sel], keep[sel]
        self._clock += 1
        stamps = (
            np.int64(self._clock) << _SUB_BITS
        ) + np.arange(q.size, dtype=np.int64)
        if not n:
            return 0
        self._insert(q[keep], r[keep], stamps[keep], h[keep])
        self.stored += n
        if self.max_items and self._size > self.max_items:
            k = self._size - self.max_items
            occ = np.nonzero(self._k >= 0)[0]
            oldest = np.argpartition(self._stamp[occ], k - 1)[:k]
            ev = occ[oldest]
            self._k[ev] = _TOMB
            self._tombs += ev.size
            self._size -= ev.size
            self.dropped += int(ev.size)
        return n

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The stored keys, rows and LRU stamps, the clock and the
        lifetime counters."""
        occ = np.nonzero(self._k >= 0)[0]
        return {"keys": self._k[occ].copy(), "rows": self._rows[occ].copy(),
                "stamps": self._stamp[occ].copy(),
                "homes": self._home[occ].copy(),
                "meta": np.asarray([self._clock, self.stored,
                                    self.restored, self.dropped], np.int64)}

    def load_state_dict(self, sd: Dict[str, np.ndarray]) -> None:
        """Inverse of ``state_dict``: the same keys, rows and LRU order (a
        state without ``homes``, written before homes were kept, loads
        with none)."""
        keys = np.asarray(sd["keys"], np.int64)
        homes = sd.get("homes")
        homes = (np.full(keys.size, -1, np.int64) if homes is None
                 else np.asarray(homes, np.int64))
        cap = self._cap
        while keys.size * 2 > cap:
            cap *= 2
        self._alloc(cap)
        self._size = 0
        if keys.size:
            self._insert(keys, np.asarray(sd["rows"], np.float32),
                         np.asarray(sd["stamps"], np.int64), homes)
        (self._clock, self.stored, self.restored,
         self.dropped) = (int(x) for x in np.asarray(sd["meta"]))

    def take(
        self, keys: np.ndarray
    ) -> Tuple[List[int], np.ndarray]:
        """Pop stored rows for the given raw keys (>= 0); returns the
        positions (indices into ``keys``) that hit and their rows
        [M, dim]. Rows are REMOVED: after restore they live in the
        device table again (keeping both would double-count the key's
        state). Duplicate keys: the first position wins."""
        keys = np.asarray(keys, np.int64).ravel()
        valid = np.nonzero(keys >= 0)[0]
        if not valid.size or not self._size:
            return [], np.zeros((0, self.dim), np.float32)
        q = keys[valid]
        slots = self._lookup(q)
        hi = np.nonzero(slots >= 0)[0]
        if not hi.size:
            return [], np.zeros((0, self.dim), np.float32)
        first = np.unique(q[hi], return_index=True)[1]
        keep = np.sort(hi[first])
        s = slots[keep]
        rows = self._rows[s].copy()
        self._k[s] = _TOMB
        self._tombs += s.size
        self._size -= s.size
        self.restored += int(s.size)
        # opportunistic cleanup: a tombstone-heavy table slows probes
        if (self._tombs * 4 > self._cap
                and self._size * 4 < self._cap):
            self._rehash(self._cap)
        return [int(i) for i in valid[keep]], rows


class SpillManager:
    """Per-zch-table spill stores + the store/restore step glue."""

    def __init__(
        self, dims: Dict[str, int], max_items: int = 0
    ) -> None:
        self.stores = {
            t: HostSpillStore(d, max_items) for t, d in dims.items()
        }

    def process(
        self, spill_out: Dict[str, Dict[str, np.ndarray]]
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Consume one step's device spill record (already device_get):
        store evictions, pop readmission hits. Returns per-table
        (slots [M] int32, rows [M, dim] float32) restores to scatter
        into the device tables (slots are table-LOCAL row indices; the
        caller offsets into its megatable layout), and the positions of
        the restored keys in the record (the order in which a one-rank
        write would take them). A record's ``held`` marks the entries
        this rank stores (all where it has none)."""
        restores: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for tname, rec in spill_out.items():
            st = self.stores[tname]
            ek = np.asarray(rec["evicted_keys"])
            if (ek >= 0).any():
                st.store(ek, np.asarray(rec["evicted_rows"]),
                         homes=np.asarray(rec["slots"]),
                         keep=rec.get("held"))
            fk = np.asarray(rec["fresh_keys"])
            idx, rows = st.take(fk)
            if idx:
                slots = np.asarray(rec["slots"])[idx].astype(np.int32)
                restores[tname] = (
                    slots, np.asarray(rows, np.float32),
                    np.asarray(idx, np.int64),
                )
        return restores

    def state_dict(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {t: st.state_dict() for t, st in self.stores.items()}

    def load_state_dict(self, sd: Dict[str, Dict[str, np.ndarray]]) -> None:
        for t, part in sd.items():
            if t in self.stores:
                self.stores[t].load_state_dict(part)

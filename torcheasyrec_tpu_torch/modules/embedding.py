"""EmbeddingGroup: feature groups -> table lookups -> group assembly.

Counterpart of the parts of torcheasyrec_tpu/modules/embedding.py that
WIDE, DEEP and (JAGGED_)SEQUENCE groups use (``__init__``, ``lookup``
and ``assemble``), with the ``sequence_groups`` nested in a WIDE or DEEP
group and the ``sequence_encoders`` hung on it (``modules/sequence.py``;
their outputs follow the group's own slots). As in the JAX package, a
SEQUENCE group's own ``sequence_encoders`` are not built. The tables
live in the embedding engine's per-(dim, dtype) groups
(``parallel/emb_engine.py``), unpacked or in the packed 128-lane
layout, held here as buffers and not as parameters: the dense optimizer
never sees them, and the train step updates their
touched rows in place through ``engine.update`` from the gradients of
``lookup``'s outputs. Features sharing an ``embedding_name`` share one
table; a WIDE group gets tables of its own, ``<name>__wide`` of
``wide_embedding_dim`` (default 4) columns, drawn from ``wide_init_fn``
where the model sets one. A table's ``init_fn`` and ``data_type`` (FP32,
BF16, FP16: the storage dtype) come from its feature config. Lookups
are gathers: id -1
(padding) reads a zero row, pooled features sum (or average) their rows.

In the ``state_dict`` each table keeps its own entry ``tables.<name>``
in canonical ``[num_buckets, dim]`` layout, whatever the grouping and
the layout, so a checkpoint written unpacked loads packed and the other
way round, and one written at one world size loads at another. Under a
``ShardContext`` (``shard``) each table takes its layout from ``plan``
({table: sharding}), else ``row_wise`` from 8192 rows and
``data_parallel`` below, as in the JAX package; a feature's
``embedding_constraints.sharding_types`` win over both. The
``state_dict`` then gathers every table from the ranks (every rank
calls it), and a load writes each rank's own rows. With
``build_tables=False`` no table is drawn: the engine is built for its
table specs alone (the planner's first pass). ``tables`` gives views into unpacked groups but copies out of
packed ones: write through ``engine.write_table``, as
``load_state_dict`` does. The encoders' parameters are the model's
dense parameters, ``encoders.<group>.<i>``. A raw feature with a dense
embedding (``autodis``, ``mlp``) takes a slot of its embedded width,
computed by ``dense_emb.<feature>`` (``AutoDisEmbedding``,
``MLPEmbedding``), whose parameters are dense ones too. A
host-offloaded table (``embedding_constraints {
sharding_types: "host_offload" }``) lives in host memory, outside the
module's buffers (``model.to`` leaves it there); its rows reach the
device per batch (``parallel/emb_engine.py``). Under INPUT_TILE serving
(``batch.tile_size`` set) a user-side feature arrives with one row; its
slot (and a user-side sequence's lengths) is broadcast on the device to
``tile_size`` rows in ``assemble``.

ZCH (the counterpart of the JAX EmbeddingGroup's ``remap_zch`` and its
spill tier): a ``zch`` or ``dynamicemb`` feature's raw ids are remapped
to slots of its table by ``parallel/zch.py``. Features that share an
``embedding_name`` share one mapping. The mappings are persistent
buffers, ``zch.<table>.{keys,count,last[,admit_cnt]}`` in the
``state_dict``, so checkpoints, exports and the serving program carry
them. ``dynamicemb`` maps onto the same table: its ``score_strategy``
picks the policy (LFU, NO_EVICTION -> lfu; STEP, TIMESTAMP -> lru) and
``frequency_admission_strategy`` the admission counter; its tables get
the host spill tier (``parallel/host_spill.py``; ``TZREC_HOST_SPILL=0``
turns it off), whose stores are ``spill``. The train step remaps with
``remap_zch(training=True)``; ``forward`` remaps read-only. A ZCH table
on the host tier raises.

ZCH over several ranks (a ``shard`` of world size N), as the JAX step
remaps on a mesh: the train remap gathers every ZCH feature's ids from
all ranks and runs the insert on their concatenation in rank order, the
global batch, so that the mappings, their scores and the admission
counters advance alike on every rank (``zch_digest`` checks it); each
rank keeps its own slice of the slots. The read-only remap of eval and
predict reads the state alone, id by id, so each rank remaps its own
ids. The spill records are then the same on every rank. Of a table
whose rows are sharded a rank stores the evicted keys whose rows it
holds and sends a readmitted key's row to the rank holding its new slot
(``apply_spill_restores``); of a column-wise or replicated table every
rank stores whole rows. ``spill_state_dict`` merges the ranks' stores
into one world-size-free state and ``load_spill_state_dict`` splits it
again by row ownership.
"""

import dataclasses
import hashlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.features.feature import BaseFeature
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.modules.sequence import create_seq_encoder
from torcheasyrec_tpu_torch.parallel import zch as zch_mod
from torcheasyrec_tpu_torch.parallel.emb_engine import (
    _ROW_SHARDED,
    COLUMN_WISE,
    DATA_PARALLEL,
    HOST_OFFLOAD,
    ROW_WISE,
    EmbeddingEngine,
    LookupSpec,
    TableSpec,
)
from torcheasyrec_tpu_torch.parallel.mesh import ShardContext
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.protos import model_pb2

# tables below this row count default to data_parallel under a
# ShardContext (the JAX package's threshold)
_DP_ROWS_THRESHOLD = 8192

# ("emb", lookup key, dim) | ("dense"|"seq_dense"|"autodis"|"mlpemb",
# feature, dim)
Slot = Tuple[str, str, int]


def _buffer_name(gk: str) -> str:
    """The buffer of a group's storage (a merged group's key, d20_s16.4,
    holds a dot, which a buffer name may not)."""
    return "group_" + gk.replace(".", "_")


class EmbeddingGroup(nn.Module):
    def __init__(self, features: List[BaseFeature], feature_groups: List[Any],
                 generator: torch.Generator,
                 sparse_optimizer: Optional[SparseOptimizer] = None,
                 wide_embedding_dim: Optional[int] = None,
                 wide_init_fn: Optional[str] = None,
                 packed: bool = True, dense_lane_rows: int = 32768,
                 shard: Optional[ShardContext] = None,
                 plan: Optional[Dict[str, str]] = None,
                 build_tables: bool = True) -> None:
        super().__init__()
        plan = plan or {}
        self._name_to_feature = {f.name: f for f in features}
        # features INPUT_TILE parses from a request's first row
        self._user_side = {f.name for f in features if f.is_user_side}
        shapes: Dict[str, Tuple[int, int]] = {}
        table_specs: Dict[str, TableSpec] = {}
        lookups: Dict[str, LookupSpec] = {}
        self._group_slots: Dict[str, List[Slot]] = {}
        self._seq_groups: Dict[str, Dict[str, Any]] = {}
        dense_emb: Dict[str, nn.Module] = {}

        def _dense_slot(feat: BaseFeature) -> Slot:
            """A dense (raw) feature's slot of its ``output_dim``; a dense
            embedding's module is built once per feature."""
            which = feat.dense_emb_kind
            if which is not None and feat.name not in dense_emb:
                d = int(feat.config.embedding_dim)
                if which == "autodis":
                    c = feat.config.autodis
                    dense_emb[feat.name] = AutoDisEmbedding(
                        int(c.num_channels), d, generator,
                        temperature=float(c.temperature),
                        keep_prob=float(c.keep_prob))
                else:
                    dense_emb[feat.name] = MLPEmbedding(
                        max(feat.value_dim, 1), d, generator)
            kind = {None: "dense", "autodis": "autodis", "mlp": "mlpemb"}
            return (kind[which], feat.name, feat.output_dim)

        def _add_table(feat: BaseFeature, suffix: str,
                       dim_override: Optional[int] = None,
                       init_override: Optional[str] = None) -> str:
            cfg = feat.emb_config()
            name = cfg.name + suffix
            shape = (cfg.num_embeddings, dim_override or cfg.embedding_dim)
            if shapes.setdefault(name, shape) != shape:
                raise ValueError(
                    f"shared embedding {name}: conflicting shapes "
                    f"{shapes[name]} vs {shape}"
                )
            sharding = plan.get(
                name, ROW_WISE if shape[0] >= _DP_ROWS_THRESHOLD
                else DATA_PARALLEL)
            if cfg.sharding_types and sharding not in cfg.sharding_types:
                # the constraint wins over the plan and the default
                sharding = cfg.sharding_types[0]
            table_specs.setdefault(name, TableSpec(
                name, shape[0], shape[1],
                dtype=(getattr(feat.config, "data_type", "FP32")
                       or "FP32").upper(),
                init_fn=init_override or cfg.init_fn or None,
                sharding=sharding,
                sharding_types=tuple(cfg.sharding_types),
                trainable=cfg.trainable))
            return name

        def _emb_slot(feat: BaseFeature, suffix: str, is_sequence: bool,
                      dim_override: Optional[int] = None,
                      init_override: Optional[str] = None) -> Slot:
            table = _add_table(feat, suffix, dim_override, init_override)
            key = f"{table}:{feat.name}" + (":seq" if is_sequence else "")
            lookups[key] = LookupSpec(
                key, feat.name, table,
                "none" if is_sequence else feat.pooling, is_sequence,
            )
            return ("emb", key, shapes[table][1])

        def _build_seq_group(seq_name: str, feature_names, suffix: str
                             ) -> None:
            if seq_name in self._seq_groups:
                raise ValueError(
                    f"duplicate sequence group name {seq_name!r}: encoders "
                    "would read another group's layout")
            q_slots, s_slots, length_feature = [], [], None
            for fname in feature_names:
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
                        else _dense_slot(feat)
                    )
            if length_feature is None:
                raise ValueError(
                    f"sequence group {seq_name} has no sequence feature"
                )
            self._seq_groups[seq_name] = {
                "query": q_slots, "sequence": s_slots,
                "length_feature": length_feature,
            }

        encoders: Dict[str, nn.ModuleList] = {}
        for group in feature_groups:
            gname = group.group_name
            suffix = getattr(group, "embedding_name_suffix", "") or ""
            if group.group_type in (model_pb2.SEQUENCE,
                                    model_pb2.JAGGED_SEQUENCE):
                # as in the JAX package, the group's own sequence_groups
                # and sequence_encoders are not built
                _build_seq_group(gname, group.feature_names, suffix)
                continue
            if group.group_type not in (model_pb2.DEEP, model_pb2.WIDE):
                raise NotImplementedError(
                    f"group {gname}: only WIDE, DEEP and sequence groups "
                    "are ported"
                )
            is_wide = group.group_type == model_pb2.WIDE
            slots: List[Slot] = []
            for fname in group.feature_names:
                feat = self._name_to_feature[fname]
                if feat.is_sequence:
                    raise ValueError(
                        f"sequence feature {fname} must be in a SEQUENCE "
                        f"group or sequence_groups (group {gname})"
                    )
                if is_wide and not feat.is_sparse:
                    raise ValueError(
                        f"dense feature {fname} should not be configured "
                        f"in wide group {gname}"
                    )
                if not feat.is_sparse:
                    slots.append(_dense_slot(feat))
                elif is_wide:
                    slots.append(_emb_slot(feat, suffix + "__wide", False,
                                           wide_embedding_dim or 4,
                                           wide_init_fn))
                else:
                    slots.append(_emb_slot(feat, suffix, False))
            self._group_slots[gname] = slots
            for sg in group.sequence_groups:
                _build_seq_group(sg.group_name or gname, sg.feature_names,
                                 sg.embedding_name_suffix or suffix)
            if len(group.sequence_encoders):
                default_input = (
                    group.sequence_groups[0].group_name or gname
                    if len(group.sequence_groups) == 1 else "")
                dims = self.seq_group_dims()
                encoders[gname] = nn.ModuleList(
                    create_seq_encoder(c, dims, generator, default_input)
                    for c in group.sequence_encoders)
        # the encoders' and the dense embeddings' parameters are dense
        # parameters of the model, under ``encoders.<group>.<i>`` and
        # ``dense_emb.<feature>``
        self.encoders = nn.ModuleDict(encoders)
        self.dense_emb = nn.ModuleDict(dense_emb)

        # ZCH and dynamicemb tables never merge: their ids are remapped in
        # the step, and a merged gather would feed the remapped slots to a
        # co-keyed plain table (a name also excludes its suffixed twins)
        self.engine = EmbeddingEngine(
            list(table_specs.values()),
            list(lookups.values()), optimizer=sparse_optimizer,
            packed=packed, dense_lane_rows=dense_lane_rows, shard=shard,
            no_merge_tables={f.embedding_name for f in features
                             if f.is_sparse and f.is_zch} or None,
        )
        self._build_zch(features, shard)
        self.device = generator.device
        self._host_stores: Dict[str, torch.Tensor] = {}
        self.spill = None
        if not build_tables:
            return
        # one storage tensor per group, a buffer named after the group,
        # initialised in place by the engine; host groups stay on the host
        for gk, store in self.engine.init_tables(generator).items():
            if self.engine.groups[gk].sharding == HOST_OFFLOAD:
                self._host_stores[gk] = store
            else:
                self.register_buffer(_buffer_name(gk), store,
                                     persistent=False)
        self.zch = nn.ModuleDict({
            t: _ZchBuffers(zch_mod.init_state(
                cfg.size, cfg.counter_size if cfg.admit_threshold > 0 else 0,
                self.device))
            for t, cfg in self._zch_cfgs.items()})
        if self._spill_tables:
            from torcheasyrec_tpu_torch.parallel.host_spill import (
                SpillManager,
            )

            self.spill = SpillManager(
                {t: table_specs[t].dim for t in sorted(self._spill_tables)})

    # -- ZCH ---------------------------------------------------------------

    def _build_zch(self, features: List[BaseFeature],
                   shard: Optional[ShardContext]) -> None:
        """``_zch_cfgs`` ({table: ZchConfig}), ``_zch_features`` ({feature:
        table}, in feature order) and the spill tables, as the JAX
        EmbeddingGroup builds them."""
        self._zch_cfgs: Dict[str, zch_mod.ZchConfig] = {}
        self._zch_features: Dict[str, str] = {}
        self._spill_tables: set = set()
        for f in features:
            if not (f.is_sparse and f.is_zch):
                continue
            table = f.embedding_name
            if f.config.HasField("zch"):
                zc = f.config.zch
                which = zc.WhichOneof("eviction_policy") or "lfu"
                decay = 1.0
                if which in ("lru", "distance_lfu"):
                    decay = float(getattr(zc, which).decay_exponent)
                cfg = zch_mod.ZchConfig(
                    size=int(zc.zch_size), policy=which,
                    decay_exponent=decay,
                    eviction_interval=int(zc.eviction_interval or 1),
                    filter_fn=zc.threshold_filtering_func or None)
            else:
                de = f.config.dynamicemb
                policy = {"LFU": "lfu", "STEP": "lru", "TIMESTAMP": "lru",
                          "NO_EVICTION": "lfu"}.get(
                              (de.score_strategy or "STEP").upper(), "lru")
                admit, counter = 0, 0
                if de.WhichOneof("admission_strategy") == (
                        "frequency_admission_strategy"):
                    fas = de.frequency_admission_strategy
                    admit = int(fas.threshold)
                    counter = int(fas.counter_capacity or 4 * de.max_capacity)
                cfg = zch_mod.ZchConfig(size=int(de.max_capacity),
                                        policy=policy, admit_threshold=admit,
                                        counter_size=counter)
                if (os.environ.get("TZREC_HOST_SPILL", "1") != "0"
                        and table in self.engine._specs):
                    self._spill_tables.add(table)
            self._zch_features[f.name] = table
            self._zch_cfgs.setdefault(table, cfg)
        if not self._zch_cfgs:
            return
        for t in self._zch_cfgs:
            gk = self.engine._table_group.get(t)
            if gk and self.engine.groups[gk].sharding == HOST_OFFLOAD:
                raise ValueError(
                    f"table {t}: zch/dynamicemb tables cannot be "
                    "host_offload (ids are remapped on the device)")

    @property
    def has_zch(self) -> bool:
        return bool(self._zch_cfgs)

    @property
    def has_host_spill(self) -> bool:
        return bool(self._spill_tables)

    def zch_states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{table: {name: buffer}}, the mappings the remap reads and the
        train step advances in place."""
        return {t: dict(m.named_buffers()) for t, m in self.zch.items()}

    @torch.no_grad()
    def remap_zch(self, batch: Batch, step: int, training: bool,
                  collect_spill: bool = False):
        """(batch with the ZCH features' ids replaced by slots, spill
        records). Features in ``_zch_features`` order, each field's
        sparse then sequence entry, the state threaded from one to the
        next; with ``training`` the buffers take the final state. With
        ``collect_spill`` the records of the spill tables
        ({table: {evicted_keys, fresh_keys, slots}}, concatenated over
        the table's features), else {}. Over several ranks a train remap
        runs on the global batch (``_global_ids``): the records are the
        global batch's, the same on every rank."""
        if not self._zch_cfgs:
            return batch, {}
        bufs = self.zch_states()
        states = {t: dict(st) for t, st in bufs.items()}
        sparse = dict(batch.sparse_features)
        seq_sparse = dict(batch.sequence_sparse_features)
        fields = [(fname, table, container)
                  for fname, table in self._zch_features.items()
                  for container in (sparse, seq_sparse)
                  if fname in container]
        shard = self.engine.shard
        glob = None
        if training and fields and shard is not None and shard.world > 1:
            glob = self._global_ids(
                [container[f].values for f, _, container in fields], shard)
        spills: Dict[str, Dict[str, list]] = {}
        for i, (fname, table, container) in enumerate(fields):
            cfg = self._zch_cfgs[table]
            want = collect_spill and table in self._spill_tables
            field = container[fname]
            ids = field.values if glob is None else glob[i][0]
            out = zch_mod.lookup_insert(states[table], cfg, ids, step,
                                        training, collect_spill=want)
            states[table] = out[1]
            if want:
                acc = spills.setdefault(table, {k: [] for k in out[2]})
                for k, v in out[2].items():
                    acc[k].append(v)
            slots = out[0]
            if glob is not None:
                lo = glob[i][1]
                slots = slots.reshape(-1)[lo:lo + field.values.numel()
                                          ].reshape(field.values.shape)
            container[fname] = dataclasses.replace(field, values=slots)
        if training:
            for t, st in states.items():
                for k, v in st.items():
                    bufs[t][k].copy_(v)
        new = dataclasses.replace(batch, sparse_features=sparse,
                                  sequence_sparse_features=seq_sparse)
        new.keep_host(batch)
        return new, {t: {k: torch.cat(v) if len(v) > 1 else v[0]
                         for k, v in rec.items()}
                     for t, rec in spills.items()}

    @staticmethod
    def _global_ids(values: List[torch.Tensor], shard: ShardContext
                    ) -> List[Tuple[torch.Tensor, int]]:
        """Per field: (every rank's ids of it, flattened and concatenated
        in rank order: the global batch's; where this rank's start in
        it). Two collectives for all fields: the per-field counts, then
        the ids, padded to the largest rank's."""
        flat = [v.reshape(-1).long() for v in values]
        sizes = torch.tensor([f.numel() for f in flat], dtype=torch.int64)
        per_rank = torch.stack(shard.all_gather_list(sizes)).tolist()
        mine = torch.cat(flat)
        padded = mine.new_zeros(max(sum(row) for row in per_rank))
        padded[:mine.shape[0]] = mine
        gathered = shard.all_gather_list(padded)
        parts = [[] for _ in flat]
        for r, row in enumerate(per_rank):
            pos = 0
            for i, n in enumerate(row):
                parts[i].append(gathered[r][pos:pos + n])
                pos += n
        return [(torch.cat(p), sum(per_rank[r][i]
                                   for r in range(shard.rank)))
                for i, p in enumerate(parts)]

    def _remap_read_only(self, batch: Batch) -> Batch:
        return self.remap_zch(batch, 0, False)[0] if self._zch_cfgs \
            else batch

    def _spill_sharded(self, table: str) -> bool:
        """Whether the rows of spill table ``table`` are split over the
        ranks (each rank then stores only the keys whose rows it holds)."""
        g = self.engine.groups[self.engine.table_rows(table)[0]]
        return self.engine.num_shards > 1 and g.sharding in _ROW_SHARDED

    @torch.no_grad()
    def gather_spill_rows(self, spills: Dict[str, Dict[str, torch.Tensor]]
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each record with ``evicted_rows`` [N, dim] fp32: the evicted
        keys' trained rows (else 0). Read the tables BEFORE the step's
        update writes them. Over several ranks, of a table whose rows
        are sharded each rank reads the rows it holds, marked ``held``;
        of a column-wise table every rank reads whole rows (a
        collective); a replicated one reads its own copy."""
        fused = self.engine_tables()
        eng = self.engine
        out = {}
        for t, rec in spills.items():
            gk, off, _ = eng.table_rows(t)
            g = eng.groups[gk]
            ids = torch.where(rec["evicted_keys"] >= 0,
                              rec["slots"].long() + off,
                              rec["slots"].new_full((), -1).long())
            extra = {}
            if self._spill_sharded(t):
                held = (ids >= g.row_lo) & (ids < g.row_lo + g.local_rows)
                rows = eng._gather(g, fused[gk], torch.where(
                    held, ids - g.row_lo, ids.new_full((), -1)))
                extra["held"] = held
            elif eng.num_shards > 1 and g.sharding == COLUMN_WISE:
                rows = eng._sharded_gather(g, fused[gk], ids)[0]
            else:
                rows = eng._gather(g, fused[gk], ids)
            out[t] = dict(rec, evicted_rows=rows.float(), **extra)
        return out

    @torch.no_grad()
    def apply_spill_restores(self, restores: Dict[str, Tuple[Any, ...]]
                             ) -> None:
        """Write readmitted keys' stored rows ({table: (slots, rows[,
        positions])}, ``SpillManager.process``'s) into the tables, weight
        columns only. Over several ranks, a table whose rows are sharded
        first gathers every rank's restores (each rank's come from its
        store), in the order of their positions in the record, and each
        rank writes those of its rows: every rank calls this each step."""
        fused = self.engine_tables()
        for t in sorted(self._spill_tables):
            gk, off, _ = self.engine.table_rows(t)
            got = restores.get(t)
            if self._spill_sharded(t):
                got = self._gather_restores(t, got)
            if got is None:
                continue
            slots, rows = got[0], got[1]
            self.engine.write_logical_rows(
                fused[gk], self.engine.groups[gk],
                torch.as_tensor(slots, dtype=torch.long) + off,
                torch.as_tensor(rows))

    def _gather_restores(self, table: str, got) -> Optional[Tuple[Any, Any]]:
        """Every rank's restores of ``table`` as one (slots, rows), by
        their positions in the (replicated) record: the order of one
        rank's writes. Packed into one float64 tensor [n, 2 + dim] of
        (position, slot, row): one gather of counts, one of rows."""
        dim = self.spill.stores[table].dim
        if got is None:
            mine = torch.zeros(0, 2 + dim, dtype=torch.float64)
        else:
            slots, rows, pos = (torch.as_tensor(x, dtype=torch.float64)
                                for x in got)
            mine = torch.cat([pos[:, None], slots[:, None], rows], 1)
        allr, _ = self.engine.shard.all_gather_var(mine)
        if allr.shape[0] == 0:
            return None
        allr = allr[torch.argsort(allr[:, 0], stable=True)]
        return allr[:, 1].long(), allr[:, 2:].float()

    def spill_step(self, spill_rec: Dict[str, Dict[str, torch.Tensor]]
                   ) -> Dict[str, Tuple[Any, ...]]:
        """The host half of the spill tier after a step: the records
        (``gather_spill_rows``') to the host, evicted rows stored,
        readmitted rows popped and written back. Returns this rank's
        restores."""
        host = {t: {k: v.cpu().numpy() for k, v in rec.items()}
                for t, rec in spill_rec.items()}
        restores = self.spill.process(host)
        if restores or self.engine.num_shards > 1:
            self.apply_spill_restores(restores)
        return restores

    def zch_digest(self) -> str:
        """A digest of every ZCH mapping (keys, scores, admission
        counters): equal on every rank while the mappings are."""
        h = hashlib.sha256()
        for t, st in sorted(self.zch_states().items()):
            for k, v in sorted(st.items()):
                h.update(f"{t}.{k}".encode())
                h.update(v.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def spill_state_dict(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The spill stores as one world-size-free state (a collective
        over the ranks; rank 0's result is the whole one): a sharded
        table's parts merged (keys, rows, stamps and homes concatenated,
        the clock shared, the counters summed), else rank 0's store."""
        own = self.spill.state_dict()
        shard = self.engine.shard
        if shard is None or shard.world <= 1:
            return own
        from torcheasyrec_tpu_torch.utils import dist_util

        parts = dist_util.gather_host_objects(shard, {
            t: sd for t, sd in own.items() if self._spill_sharded(t)})
        out = {}
        for t, sd in own.items():
            if not self._spill_sharded(t):
                out[t] = sd
                continue
            ps = [p[t] for p in parts]
            merged = {k: np.concatenate([p[k] for p in ps])
                      for k in ("keys", "rows", "stamps", "homes")}
            metas = np.stack([p["meta"] for p in ps])
            merged["meta"] = np.concatenate(
                [metas[:, :1].max(0), metas[:, 1:].sum(0)])
            out[t] = merged
        return out

    def load_spill_state_dict(self, sd: Dict[str, Dict[str, np.ndarray]]
                              ) -> None:
        """Inverse of ``spill_state_dict`` at this world size and layout:
        a sharded table's rank keeps the entries whose home row it holds
        (an entry without a home goes to rank 0) and rank 0 the
        counters; every rank keeps a replicated table's whole state."""
        mine = {}
        for t, part in sd.items():
            if t not in self.spill.stores:
                continue
            part = {k: np.asarray(v) for k, v in part.items()}
            if self._spill_sharded(t):
                gk, off, _ = self.engine.table_rows(t)
                g = self.engine.groups[gk]
                homes = part.get("homes")
                if homes is None:
                    homes = np.full(part["keys"].shape, -1, np.int64)
                row = homes + off
                keep = np.where(homes >= 0, (row >= g.row_lo)
                                & (row < g.row_lo + g.local_rows),
                                self.engine.rank == 0)
                part = dict({k: part[k][keep] for k in ("keys", "rows",
                                                        "stamps")},
                            homes=homes[keep], meta=part["meta"].copy())
                if self.engine.rank:
                    part["meta"][1:] = 0
            mine[t] = part
        self.spill.load_state_dict(mine)

    # -- tables ------------------------------------------------------------

    def engine_tables(self) -> Dict[str, torch.Tensor]:
        """{group key: the group's storage}, as the engine takes them (a
        host group's on the host)."""
        return {gk: self._host_stores[gk] if gk in self._host_stores
                else getattr(self, _buffer_name(gk))
                for gk in self.engine.groups}

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        """{table name: [num_buckets, dim]}: a view into an unpacked
        group, a copy out of a packed one."""
        fused = self.engine_tables()
        return {name: self.engine.extract_table(fused, name)
                for name in self.engine._specs}

    def table_specs(self) -> List[TableSpec]:
        """The engine's table specs, for the planner."""
        return list(self.engine._specs.values())

    def init_opt_state(self) -> Dict[str, Any]:
        return self.engine.init_opt_state(self.device)

    def opt_state_dict(self, opt_state: Dict[str, Any]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The sparse optimizer state per table, whatever the layout:
        {table name: ``engine.extract_table_state``}. Row state of packed
        groups comes out of their rows. Sharded: gathered table by table
        onto the host."""
        fused = self.engine_tables()
        out = {}
        for name in self.engine._specs:
            st = self.engine.extract_table_state(fused, opt_state, name)
            out[name] = {k: self._to_host(v) for k, v in st.items()}
        return out

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A gathered table off the card (sharded groups only: device
        memory then holds one gathered table at a time)."""
        return t.cpu() if self.engine.shard is not None else t

    def load_opt_state_dict(self, per_table: Dict[str, Dict[str, Any]]
                            ) -> Dict[str, Any]:
        """Inverse of ``opt_state_dict``: a fresh engine state with every
        table's state written in (into the rows of packed groups)."""
        fused = self.engine_tables()
        opt_state = self.init_opt_state()
        for name, st in per_table.items():
            self.engine.write_table_state(fused, opt_state, name, st)
        return opt_state

    def _save_to_state_dict(self, destination, prefix, keep_vars) -> None:
        fused = self.engine_tables()
        for name in self.engine._specs:
            t = self._to_host(self.engine.extract_table(fused, name))
            destination[f"{prefix}tables.{name}"] = (
                t if keep_vars else t.detach())

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs) -> None:
        fused = self.engine_tables()
        specs = self.engine._specs
        for name, spec in specs.items():
            key = f"{prefix}tables.{name}"
            shape = (spec.rows, spec.dim)
            if key not in state_dict:
                missing_keys.append(key)
            elif tuple(state_dict[key].shape) != shape:
                error_msgs.append(
                    f"size mismatch for {key}: {tuple(state_dict[key].shape)}"
                    f" in the checkpoint, {shape} in the model")
            else:
                self.engine.write_table(fused, name, state_dict[key])
        if strict:
            # the encoders' keys are their own modules'
            for k in state_dict:
                if not k.startswith(prefix):
                    continue
                head, _, rest = k[len(prefix):].partition(".")
                if (rest not in specs if head == "tables"
                        else head not in self._modules):
                    unexpected_keys.append(k)

    # -- dims API ----------------------------------------------------------

    def group_dims(self, group_name: str) -> List[int]:
        """A sequence group's sequence slots; a WIDE or DEEP group's slots,
        then its encoders' outputs."""
        if group_name in self._seq_groups:
            return [d for _, _, d in self._seq_groups[group_name]["sequence"]]
        return [d for _, _, d in self._group_slots[group_name]] + [
            enc.output_dim() for enc in self._encoders(group_name)]

    def _encoders(self, group_name: str):
        return self.encoders[group_name] if group_name in self.encoders else []

    def group_total_dim(self, group_name: str) -> int:
        return sum(self.group_dims(group_name))

    def seq_group_dims(self) -> Dict[str, int]:
        out = {}
        for name, sg in self._seq_groups.items():
            out[f"{name}.query"] = sum(d for _, _, d in sg["query"])
            out[f"{name}.sequence"] = sum(d for _, _, d in sg["sequence"])
        return out

    def group_names(self) -> List[str]:
        """The non-sequence groups' names, in config order."""
        return list(self._group_slots)

    def has_group(self, group_name: str) -> bool:
        return group_name in self._group_slots or group_name in self._seq_groups

    def groups_closure(self, group_names) -> List[str]:
        """The group names, then the sequence groups their encoders read."""
        out = list(dict.fromkeys(group_names))
        for g in group_names:
            for enc in self._encoders(g):
                if enc.input not in out:
                    out.append(enc.input)
        return out

    def features_for_groups(self, group_names) -> List[str]:
        """The feature names a subset of groups reads (a tower's fg.json
        and its loader's columns), in slot order."""
        names: List[str] = []

        def add(slot: Slot) -> None:
            kind, key, _ = slot
            f = key.split(":")[1] if kind == "emb" else key
            if f not in names:
                names.append(f)

        for g in group_names:
            sg = self._seq_groups.get(g)
            if sg is not None:
                for slot in sg["query"] + sg["sequence"]:
                    add(slot)
                if sg["length_feature"] not in names:
                    names.append(sg["length_feature"])
            for slot in self._group_slots.get(g, []):
                add(slot)
        return names

    def tables_for_groups(self, group_names) -> set:
        return self.engine.tables_for_features(
            set(self.features_for_groups(group_names)))

    # -- forward -----------------------------------------------------------

    def lookup(self, batch: Batch, groups: Optional[List[str]] = None,
               host_rows: Optional[Dict[str, Any]] = None, staged=None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Engine lookup only (no ZCH remap): (emb_out, residuals).
        emb_out holds fp32
        lookups, [B, L, D] per sequence feature and [B, D] pooled. The
        train step takes gradients with respect to emb_out and routes
        them, with the residuals, to ``engine.update``. ``groups`` looks
        up those groups' features only. Host groups read ``host_rows``
        (``host_gather``'s) where given, else gather from the batch's host
        copy (``batch.host``, which the loader keeps; a batch on the host
        is its own; else its ids are copied off the device). ``staged``
        is ``stage_route``'s of this batch."""
        return self.engine.lookup(
            self.engine_tables(), batch.sparse_features,
            batch.sequence_sparse_features,
            feature_filter=(None if groups is None
                            else set(self.features_for_groups(groups))),
            host_rows=host_rows, host_fields=self.host_fields(batch),
            staged=staged,
        )

    def stage_route(self, batch: Batch):
        """Start the batch's owner routes ahead of its step
        (``engine.stage_route``; None where nothing routes). The groups
        of ZCH and dynamicemb tables are skipped: their ids exist only
        after the step's remap, and a route of the raw ids would serve
        the wrong rows."""
        skip = {self.engine._table_group[t] for t in self._zch_cfgs
                if t in self.engine._table_group}
        return self.engine.stage_route(batch.sparse_features,
                                       batch.sequence_sparse_features,
                                       skip_groups=skip)

    def host_fields(self, batch: Batch):
        """(sparse, sequence sparse) fields of the batch on the host where
        the batch has them (its loader's host copy, or itself on the
        host), else None."""
        if not self.engine.has_host_groups:
            return None
        host = getattr(batch, "host", None)
        if host is None:
            f = next(iter(batch.sparse_features.values()), None)
            if f is None or f.values.device.type != "cpu":
                return None
            host = batch
        return host.sparse_features, host.sequence_sparse_features

    def host_gather(self, batch: Batch) -> Dict[str, Any]:
        """{host group: (rows, ids)} of the batch, gathered on the host
        into page-locked memory (``engine.host_gather``), for the train
        step."""
        from torcheasyrec_tpu_torch.parallel.emb_engine import _fields_to_cpu

        hs, hq = self.host_fields(batch) or (
            _fields_to_cpu(batch.sparse_features),
            _fields_to_cpu(batch.sequence_sparse_features))
        return self.engine.host_gather(self.engine_tables(), hs, hq,
                                       pin=True)

    def forward(self, batch: Batch, compute_dtype: torch.dtype,
                groups: Optional[List[str]] = None
                ) -> Dict[str, torch.Tensor]:
        """Read-only ZCH remap, lookup and ``assemble``, for eval and
        predict; ``groups`` (a tower's group closure) restricts both."""
        batch = self._remap_read_only(batch)
        return self.assemble(self.lookup(batch, groups)[0], batch,
                             compute_dtype, groups)

    def assemble(self, emb_out: Dict[str, torch.Tensor], batch: Batch,
                 compute_dtype: torch.dtype,
                 groups: Optional[List[str]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Group concat and sequence encoders, a function of ``emb_out``:
        ``{g}.query``, ``{g}.sequence`` and ``{g}.sequence_length`` for
        sequence groups first, then ``{group}`` [B, D] for WIDE and DEEP
        groups, each its slots followed by its encoders' outputs. Values
        are cast to ``compute_dtype``. ``groups`` assembles those groups
        only."""
        gset = None if groups is None else set(groups)
        tile = batch.tile_size

        def _tiled(v: torch.Tensor, fname: str) -> torch.Tensor:
            # INPUT_TILE: a user-side feature's one row, broadcast on the
            # device to the batch's rows
            if tile is not None and fname in self._user_side and (
                    v.shape[0] == 1):
                return v.expand(tile, *v.shape[1:])
            return v

        def _slot_value(slot: Slot) -> torch.Tensor:
            kind, key, _ = slot
            if kind == "emb":
                return _tiled(emb_out[key].to(compute_dtype),
                              key.split(":")[1])
            if kind == "seq_dense":
                return _tiled(batch.sequence_dense_features[key].values.to(
                    compute_dtype), key)
            return _tiled(self._dense_value(slot, batch, compute_dtype), key)

        result: Dict[str, torch.Tensor] = {}
        for name, sg in self._seq_groups.items():
            if gset is not None and name not in gset:
                continue
            lf = sg["length_feature"]
            if lf in batch.sequence_sparse_features:
                lengths = batch.sequence_sparse_features[lf].lengths
            else:
                lengths = batch.sequence_dense_features[lf].lengths
            lengths = _tiled(lengths, lf)
            if sg["query"]:
                result[f"{name}.query"] = torch.cat(
                    [_slot_value(s) for s in sg["query"]], dim=-1
                )
            result[f"{name}.sequence"] = torch.cat(
                [_slot_value(s) for s in sg["sequence"]], dim=-1
            )
            result[f"{name}.sequence_length"] = lengths
        for gname, slots in self._group_slots.items():
            if gset is not None and gname not in gset:
                continue
            vals = [_slot_value(s) for s in slots]
            vals += [enc(result, compute_dtype)
                     for enc in self._encoders(gname)]
            result[gname] = torch.cat(vals, dim=-1)
        return result

    def query_features(self, seq_group: str) -> List[str]:
        """The features of a sequence group's query slots, in slot
        order."""
        return [key.split(":")[1] if kind == "emb" else key
                for kind, key, _ in self._seq_groups[seq_group]["query"]]

    def node_embedding(self, batch: Batch, compute_dtype: torch.dtype,
                       seq_group: str) -> torch.Tensor:
        """A candidate's (TDM tree node's) embedding: the concatenated
        query slots of ``seq_group``, looked up alone (the engine's
        feature filter keeps every other feature, and its tables, out)."""
        batch = self._remap_read_only(batch)
        emb_out, _ = self.engine.lookup(
            self.engine_tables(), batch.sparse_features,
            batch.sequence_sparse_features,
            feature_filter=set(self.query_features(seq_group)),
            host_fields=self.host_fields(batch))
        vals = [emb_out[slot[1]].to(compute_dtype) if slot[0] == "emb"
                else self._dense_value(slot, batch, compute_dtype)
                for slot in self._seq_groups[seq_group]["query"]]
        return torch.cat(vals, dim=-1) if len(vals) > 1 else vals[0]

    def _dense_value(self, slot: Slot, batch: Batch,
                     compute_dtype: torch.dtype) -> torch.Tensor:
        """A dense slot's values in ``compute_dtype``, through its dense
        embedding where it has one."""
        kind, key, _ = slot
        v = batch.dense_features[key].values.to(compute_dtype)
        if kind in ("autodis", "mlpemb"):
            v = self.dense_emb[key](v, compute_dtype)
        return v


class _ZchBuffers(nn.Module):
    """One table's ZCH mapping as persistent buffers."""

    def __init__(self, state: Dict[str, torch.Tensor]) -> None:
        super().__init__()
        for k, v in state.items():
            self.register_buffer(k, v)


class AutoDisEmbedding(nn.Module):
    """AutoDis learnable discretization of dense values, each of the
    input's columns on its own: h = leaky_relu(x * w1) [B, C]; logits =
    h @ w2 + keep_prob * h; out = softmax(logits / temperature) @ meta
    [B, d]; the columns' outputs concatenate to [B, n * d]. Computed in
    fp32 from the input in the compute dtype, cast to it at the end, as
    the JAX package's ``AutoDisEmbedding``. ``w1`` [C], ``w2`` [C, C] and
    ``meta`` [C, d] are drawn from N(0, 0.1^2)."""

    def __init__(self, num_channels: int, embedding_dim: int,
                 generator: torch.Generator, temperature: float = 0.1,
                 keep_prob: float = 0.8) -> None:
        super().__init__()
        dev = generator.device
        c, d = num_channels, embedding_dim
        self.d = d
        self.temperature = temperature
        self.keep_prob = keep_prob

        def normal(*shape):
            return nn.Parameter(torch.randn(
                *shape, generator=generator, device=dev) * 0.1)

        self.w1 = normal(c)
        self.w2 = normal(c, c)
        self.meta = normal(c, d)

    def output_dim(self) -> int:
        return self.d

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        outs = []
        for i in range(x.shape[-1]):
            h = F.leaky_relu(x[..., i:i + 1] * self.w1)
            logits = h @ self.w2 + self.keep_prob * h
            p = torch.softmax(logits / self.temperature, dim=-1)
            outs.append(p @ self.meta)
        out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        return out.to(compute_dtype)


class MLPEmbedding(nn.Module):
    """A linear projection of a dense value vector [B, n] to [B, d]
    (``linear``, drawn as every linear is)."""

    def __init__(self, in_dim: int, embedding_dim: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.d = embedding_dim
        self.linear = linear(in_dim, embedding_dim, generator)

    def output_dim(self) -> int:
        return self.d

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        return linear_apply(self.linear, x, compute_dtype)

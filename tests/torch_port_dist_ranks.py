"""What the ranks of the multi-process port tests run: importable by
name from a spawned process, and free of JAX (the parent process holds
the JAX references). Each function takes the rank's ``ShardContext``
first, as ``dist_util.spawn_ranks`` calls it, and returns numpy arrays.
"""

import os

import numpy as np
import torch

# (name, rows, dim) of the engine tests: two dims, a table past the
# data-parallel threshold, collisions across ranks in every step
ENGINE_TABLES = [("t_a", 120, 16), ("t_b", 50, 16), ("t_c", 30, 8),
                 ("t_d", 9000, 8)]
# (output key, feature, table, combiner, is_sequence)
ENGINE_LOOKUPS = [("a", "f_a", "t_a", "sum", False),
                  ("b", "f_b", "t_b", "mean", False),
                  ("c", "f_c", "t_c", "sum", False),
                  ("d", "f_d", "t_d", "sum", False),
                  ("s", "f_s", "t_a", "none", True)]
ENGINE_B = 16  # the global batch; each of 2 ranks takes 8 rows


def engine_batch(seed: int):
    """{feature: (ids, lengths or None)}: fixed multi-value fields with
    -1 padding and a sequence field, ids from small ranges."""
    r = np.random.default_rng(seed)
    b = ENGINE_B
    f_a = r.integers(0, 120, (b, 3))
    f_a[r.random((b, 3)) < 0.2] = -1
    f_a[b // 2] = f_a[0]  # the same ids on both ranks
    f_d = r.integers(0, 40, (b, 2)) * 200  # rows of every shard
    return {"f_a": (f_a, None), "f_b": (r.integers(0, 50, (b, 2)), None),
            "f_c": (r.integers(0, 30, (b, 1)), None), "f_d": (f_d, None),
            "f_s": (r.integers(-1, 120, (b, 4)),
                    r.integers(0, 5, b).astype(np.int32))}


def engine_grads(outputs_shapes, seed: int):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=s).astype(np.float32)
            for k, s in sorted(outputs_shapes.items())}


def port_fields(batch, rows=slice(None)):
    from torcheasyrec_tpu_torch.datasets.utils import SparseField

    sparse, seq = {}, {}
    for k, (v, lengths) in batch.items():
        f = SparseField(torch.from_numpy(v[rows].astype(np.int32)),
                        lengths=None if lengths is None
                        else torch.from_numpy(lengths[rows]))
        (seq if k == "f_s" else sparse)[k] = f
    return sparse, seq


def port_engine(kind, cfg, layout, packed, shard=None):
    from torcheasyrec_tpu_torch.parallel.emb_engine import (
        EmbeddingEngine,
        LookupSpec,
        TableSpec,
    )
    from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer

    return EmbeddingEngine(
        [TableSpec(n, r, d, sharding=layout) for n, r, d in ENGINE_TABLES],
        [LookupSpec(k, f, t, c, s) for k, f, t, c, s in ENGINE_LOOKUPS],
        SparseOptimizer(kind, cfg), packed=packed, shard=shard)


def run_engine(eng, canon, steps, rows=slice(None)):
    """Write ``canon`` ({table: [rows, dim]}), then per step a lookup of
    the step's batch rows and an update from the step's gradient rows.
    Returns (outputs per step, {table: weights}, {table: {state:
    array}}, {table: (``read_rows``, ``read_row_state``) at every third
    row})."""
    gen = torch.Generator().manual_seed(0)
    tables = eng.init_tables(gen)
    for name, w in canon.items():
        eng.write_table(tables, name, torch.from_numpy(w))
    state = eng.init_opt_state()
    outs = []
    for batch, grads in steps:
        sparse, seq = port_fields(batch, rows)
        out, res = eng.lookup(tables, sparse, seq)
        outs.append({k: v.float().numpy() for k, v in out.items()})
        eng.update(tables, state, res,
                   {k: torch.from_numpy(g[rows]) for k, g in grads.items()},
                   0.5)
    weights = {n: eng.extract_table(tables, n).float().numpy()
               for n, _, _ in ENGINE_TABLES}
    st = {n: {k: np.asarray(v.float().numpy())
              for k, v in eng.extract_table_state(tables, state, n).items()}
          for n, _, _ in ENGINE_TABLES}
    reads = {}
    for n, r, _ in ENGINE_TABLES:
        probe = torch.arange(0, r, 3)
        reads[n] = (eng.read_rows(tables, n, probe).numpy(),
                    {k: v.numpy() for k, v in
                     eng.read_row_state(tables, state, n, probe).items()})
    return outs, weights, st, reads


def engine_cases_rank(shard, cases, canon, steps):
    """Every case (layout, kind, cfg, packed) on this rank's half of
    every step's batch."""
    half = ENGINE_B // shard.world
    rows = slice(shard.rank * half, (shard.rank + 1) * half)
    out = []
    for layout, kind, cfg, packed in cases:
        eng = port_engine(kind, cfg, layout, packed, shard)
        out.append(run_engine(eng, canon, steps, rows))
    return out


def init_tables_of(layout, chunk, shard=None):
    """{table: the whole table} of an engine drawn from seed 42, its
    tables of more than ``chunk`` rows drawn by chunk (gathered from the
    ranks under ``shard``)."""
    from torcheasyrec_tpu_torch.parallel.emb_engine import EmbeddingEngine

    kept = EmbeddingEngine._INIT_CHUNK
    EmbeddingEngine._INIT_CHUNK = chunk
    try:
        eng = port_engine("adagrad", {"lr": 0.1}, layout, True, shard)
        tables = eng.init_tables(torch.Generator().manual_seed(42))
    finally:
        EmbeddingEngine._INIT_CHUNK = kept
    return {n: eng.extract_table(tables, n).numpy()
            for n, _, _ in ENGINE_TABLES}


def init_rank(shard, cases):
    """{(layout, chunk): ``init_tables_of``} at this rank's world size."""
    return {case: init_tables_of(*case, shard=shard) for case in cases}


def engine_and_init_rank(shard, cases, canon, steps, layouts):
    return engine_cases_rank(shard, cases, canon, steps), init_rank(
        shard, layouts)


# --- train steps -------------------------------------------------------------


def _local_cols(cols, rank, world):
    n = len(next(iter(cols.values())))
    per = n // world
    return {k: v.slice(rank * per, per) for k, v in cols.items()}


def train_case(shard, cfg_text, canon, steps_cols, labels, plan):
    """3 (or len(steps_cols)) train steps of the port from the state_dict
    ``canon`` on this rank's rows of each step's columns. Returns
    (state_dict, sparse optimizer state per table, losses per step), the
    tables gathered from every rank."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(cfg_text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, shard=shard, plan=plan)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in canon.items()})
    tx, dense_sched = port_main._dense_optimizer(model, cfg.train_config)
    state = port_main._init_state(model, tx)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    parser = DataParser(features, labels=labels)
    losses = []
    for cols in steps_cols:
        local = cols if shard is None else _local_cols(
            cols, shard.rank, shard.world)
        state, metrics = step(state, parser.parse_to_batch(local))
        losses.append(float(metrics["total_loss"]))
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    opt = {n: {k: v.float().numpy() for k, v in st.items()}
           for n, st in model.embedding_group.opt_state_dict(
               state["sparse_opt"]).items()}
    return sd, opt, losses


def train_cases_rank(shard, cases):
    return [train_case(shard, *case) for case in cases]


# --- entry points and builds ------------------------------------------------


def entry_points_rank(shard, cfg_path, more_steps):
    """``train_and_evaluate`` (one epoch, each rank its files), then
    ``evaluate`` of its checkpoint, then a ``continue_train`` of
    ``more_steps`` more steps (in a second epoch: the shorter shard has
    no rows left in the first) that must reuse ``sharding_plan.json``
    (the planner raises if it runs)."""
    import json

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.parallel import planner

    first = port_main.train_and_evaluate(cfg_path, device="cpu", shard=shard)
    ev = port_main.evaluate(cfg_path, device="cpu", shard=shard)

    def no_planner(*args, **kwargs):
        raise AssertionError("the planner ran on continue_train")

    planner.plan_cost = no_planner
    steps = int(first["step"]) + more_steps
    again = port_main.train_and_evaluate(
        cfg_path, device="cpu", shard=shard, continue_train=True,
        edit_config_json=json.dumps({"train_config.num_steps": steps,
                                     "train_config.num_epochs": 2}))
    return first, ev, again


def refusals_rank(shard, cfg_texts):
    """{name: the NotImplementedError's message, or None} of building
    each config at this world size."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    out = {}
    for name, text in cfg_texts.items():
        try:
            port_main._build_model_and_optim(
                parse_pipeline_config(text), "cpu", shard=shard,
                plan={})
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def whole_file_rank(shard, train_cases, cfg_path, more_steps, cfg_texts):
    """The train-step cases, the entry points and the builds, in one
    spawn."""
    return (train_cases_rank(shard, train_cases),
            entry_points_rank(shard, cfg_path, more_steps),
            refusals_rank(shard, cfg_texts))


# --- ZCH over ranks ------------------------------------------------------------

# the rows of each global batch that rank 0 takes (rank 1 the rest)
ZCH_SPLIT = 0.625


def zch_rows(n: int, rank: int) -> slice:
    cut = int(n * ZCH_SPLIT)
    return slice(0, cut) if rank == 0 else slice(cut, n)


def zch_remap_group(zch_text: str, shard=None):
    """An EmbeddingGroup of two features sharing one ZCH table: ``a``
    (two ids a row) and ``b`` (a jagged list)."""
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    feats = create_features([text_format.Parse(
        f"id_feature {{ feature_name: '{n}' embedding_dim: 8 "
        f"embedding_name: 'ab_emb' {zch_text} }}",
        feature_pb2.FeatureConfig()) for n in ("a", "b")])
    mc = text_format.Parse(
        'feature_groups { group_name: "g" feature_names: "a" '
        'feature_names: "b" group_type: DEEP }', model_pb2.ModelConfig())
    return EmbeddingGroup(feats, list(mc.feature_groups), torch.Generator(),
                          shard=shard)


def zch_remap_batch(step_batch, rows: slice):
    """A Batch of this rank's rows of one global batch ({"a": [B, 2],
    "b": (values, lengths)})."""
    from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField

    a = step_batch["a"][rows]
    bv, bl = step_batch["b"]
    ends = np.concatenate([[0], np.cumsum(bl)])
    lo, hi = ends[rows.start], ends[rows.stop]
    return Batch(sparse_features={
        "a": SparseField(torch.from_numpy(a.astype(np.int32))),
        "b": SparseField(torch.from_numpy(bv[lo:hi].astype(np.int32)),
                         lengths=torch.from_numpy(bl[rows].astype(np.int32))),
    })


def zch_remap_case(shard, zch_text, batches, train_flags):
    """Per step: (this rank's slots of ``a`` and ``b``, the spill record
    of the table or None); then the final mapping."""
    eg = zch_remap_group(zch_text, shard)
    out = []
    for i, (b, training) in enumerate(zip(batches, train_flags)):
        n = b["a"].shape[0]
        batch = zch_remap_batch(b, zch_rows(n, shard.rank))
        nb, rec = eg.remap_zch(batch, i, training,
                               collect_spill=eg.has_host_spill)
        out.append((nb.sparse_features["a"].values.numpy(),
                    nb.sparse_features["b"].values.numpy(),
                    {k: v.numpy() for k, v in rec.get("ab_emb", {}).items()}
                    or None))
    final = {k: v.numpy().copy()
             for k, v in eg.zch_states()["ab_emb"].items()}
    return out, final


def zch_deepfm_steps(shard, cfg_text, plan, canon, steps_cols, eval_cols,
                     ckpt_dir):
    """The ZCH DeepFM: 3 train steps from ``canon`` on this rank's rows
    of each global batch, then the world-2 checkpoint, the predictions
    of ``eval_cols`` (all rows, on every rank), and the round trips:
    rank 0 alone restores the world-2 checkpoint at world size 1,
    predicts and saves it again; both ranks restore that at world size 2
    and predict. Returns (state_dict, spill state, losses, [predictions
    at world 2, at 1 (rank 0), at 2 after 1], per step and table the
    restores this rank took from its store and how many of them went to
    a slot another rank holds)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(cfg_text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, shard=shard, plan=plan)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in canon.items()})
    tx, dense_sched = port_main._dense_optimizer(model, cfg.train_config)
    state = port_main._init_state(model, tx)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    eg = model.embedding_group
    restores, spill_step = [], eg.spill_step

    def counted(rec):
        got = spill_step(rec)
        held = {}
        for t, r in got.items():
            gk, off, _ = eg.engine.table_rows(t)
            g = eg.engine.groups[gk]
            rows = np.asarray(r[0]) + off
            held[t] = (len(rows), int(((rows < g.row_lo) | (
                rows >= g.row_lo + g.local_rows)).sum()))
        restores.append(held)
        return got

    eg.spill_step = counted
    parser = DataParser(features, labels=["label"])
    losses = []
    for cols in steps_cols:
        n = len(cols["label"])
        rows = zch_rows(n, shard.rank)
        local = {k: v.slice(rows.start, rows.stop - rows.start)
                 for k, v in cols.items()}
        state, metrics = step(state, parser.parse_to_batch(local))
        losses.append(float(metrics["total_loss"]))
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    spill = eg.spill_state_dict()
    for sub in ("/w2", "/w1"):
        os.makedirs(ckpt_dir + sub, exist_ok=True)
    path_a = checkpoint_util.save_checkpoint(ckpt_dir + "/w2", model, tx,
                                             state)

    def predict(m):
        m.eval()
        with torch.no_grad():
            preds = port_main.make_eval_step(m, with_loss=False)(
                DataParser(features, labels=[]).parse_to_batch(eval_cols))
        return preds[0] if isinstance(preds, tuple) else preds

    def as_np(preds):
        return {k: v.float().numpy() for k, v in preds.items()
                if isinstance(v, torch.Tensor)}

    preds = [as_np(predict(model))]
    if shard.rank == 0:
        one, _, _ = port_main._build_model_and_optim(cfg, "cpu",
                                                     for_train=True)
        tx1, _ = port_main._dense_optimizer(one, cfg.train_config)
        st1 = checkpoint_util.restore_checkpoint(path_a, one, tx1)
        preds.append(as_np(predict(one)))
        checkpoint_util.save_checkpoint(ckpt_dir + "/w1", one, tx1, st1)
    shard.barrier()
    two, _, _ = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, shard=shard, plan=plan)
    tx2, _ = port_main._dense_optimizer(two, cfg.train_config)
    checkpoint_util.restore_checkpoint(
        checkpoint_util.latest_checkpoint(ckpt_dir + "/w1"), two, tx2)
    preds.append(as_np(predict(two)))
    return sd, spill, losses, preds, restores, two.embedding_group.spill_state_dict()


def zch_spill_mirror(shard, waves: int = 40):
    """The JAX package's ``test_spill_restore_row_wise_mesh`` over two
    ranks: a dynamicemb table of 8 slots, ``row_wise`` and packed. Key A
    is admitted, its row written, flooded out, stored and readmitted.
    Returns (packed and row_wise, A's first slot, the table's first row,
    rows a rank holds, [(wave, A in this rank's store, its stored row)],
    A's new slot, its row read back, the restores this rank sent)."""
    from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    dim = 8
    feats = create_features([text_format.Parse(
        f"id_feature {{ feature_name: 'dyn' embedding_dim: {dim} "
        "dynamicemb { max_capacity: 8 score_strategy: 'LFU' } }",
        feature_pb2.FeatureConfig())])
    mc = text_format.Parse('feature_groups { group_name: "deep" '
                           'feature_names: "dyn" group_type: DEEP }',
                           model_pb2.ModelConfig())
    eg = EmbeddingGroup(feats, list(mc.feature_groups), torch.Generator(),
                        shard=shard, plan={"dyn_emb": "row_wise"})
    gk, off, _ = eg.engine.table_rows("dyn_emb")
    g = eg.engine.groups[gk]
    sent = []

    def step(ids, i):
        ids = np.asarray(ids)
        mine = ids[zch_rows(len(ids), shard.rank)]
        batch = Batch(sparse_features={"dyn": SparseField(
            torch.tensor(mine, dtype=torch.int32)[:, None])})
        nb, spills = eg.remap_zch(batch, i, True, collect_spill=True)
        got = eg.spill_step(eg.gather_spill_rows(spills))
        sent.extend(int(s) for r in got.values() for s in r[0])
        # every rank's slots: the global batch's
        return eg._global_ids([nb.sparse_features["dyn"].values],
                              shard)[0][0]

    key = 777_001
    v = torch.linspace(3.0, 4.0, dim)
    slot = int(step([key] * 8, 1)[0])
    eg.engine.write_logical_rows(eg.engine_tables()[gk], g,
                                 torch.tensor([off + slot]), v[None])
    store = eg.spill.stores["dyn_emb"]
    seen, i = [], 2
    for wave in range(waves):
        for _ in range(3):
            step([5000 + 16 * wave + j for j in range(16)], i)
            i += 1
        here = key in store
        flags = eg.engine.shard.all_gather_list(torch.tensor([int(here)]))
        seen.append((wave, here, store.get(key) if here else None))
        if any(int(f) for f in flags):
            break
    new_slot = -1
    for _ in range(30):
        s = int(step([key] * 8, i)[0])
        i += 1
        gone = eg.engine.shard.all_gather_list(
            torch.tensor([int(key in store)]))
        if not any(int(f) for f in gone) and s >= 0:
            new_slot = s
            break
    got = eg.engine.read_rows(eg.engine_tables(), "dyn_emb",
                              torch.tensor([max(new_slot, 0)]))[0].numpy()
    return (g.packed and g.sharding == "row_wise", slot, off, g.local_rows,
            g.row_lo, seen, new_slot, got, sent)


def zch_entry_points(shard, cfg_path, half_steps):
    """``train_and_evaluate`` of the ZCH DeepFM to step ``half_steps``,
    a ``continue_train`` to twice that, ``evaluate`` of the result."""
    import json

    from torcheasyrec_tpu_torch import main as port_main

    first = port_main.train_and_evaluate(
        cfg_path, device="cpu", shard=shard, edit_config_json=json.dumps(
            {"train_config.num_steps": half_steps}))
    again = port_main.train_and_evaluate(cfg_path, device="cpu", shard=shard,
                                         continue_train=True)
    ev = port_main.evaluate(cfg_path, device="cpu", shard=shard)
    return first, again, ev


def zch_restore_routing(shard):
    """``apply_spill_restores`` of a row_wise packed dynamicemb table of
    16 slots: rank r restores (from its own store) rows into slots of
    the other rank's block, rank 0 two into one slot at positions 5 and
    rank 1 one into it at position 3. Returns (the rows read back at the
    slots, the rows expected: the highest position's for the shared
    slot)."""
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    feats = create_features([text_format.Parse(
        "id_feature { feature_name: 'dyn' embedding_dim: 8 "
        "dynamicemb { max_capacity: 16 score_strategy: 'LFU' } }",
        feature_pb2.FeatureConfig())])
    mc = text_format.Parse('feature_groups { group_name: "deep" '
                           'feature_names: "dyn" group_type: DEEP }',
                           model_pb2.ModelConfig())
    eg = EmbeddingGroup(feats, list(mc.feature_groups), torch.Generator(),
                        shard=shard, plan={"dyn_emb": "row_wise"})
    g = eg.engine.groups[eg.engine.table_rows("dyn_emb")[0]]
    assert g.packed and g.local_rows < 16
    rows = {r: np.full((3, 8), 10.0 * r + 1, np.float32)
            + np.arange(3, dtype=np.float32)[:, None] for r in range(2)}
    # rank 0: slots 14, 15 (rank 1's) at positions 0, 5; rank 1: slot 1
    # (rank 0's) at position 2 and slot 15 at position 3
    plan = {0: ([14, 15, 0], [0, 5, 9]), 1: ([1, 15, 2], [2, 3, 7])}
    slots, pos = plan[shard.rank]
    eg.apply_spill_restores({"dyn_emb": (
        np.asarray(slots, np.int32), rows[shard.rank],
        np.asarray(pos, np.int64))})
    probe = torch.tensor([14, 15, 0, 1, 2])
    got = eg.engine.read_rows(eg.engine_tables(), "dyn_emb", probe).numpy()
    want = np.stack([rows[0][0], rows[0][1], rows[0][2], rows[1][0],
                     rows[1][2]])
    return got, want


def zch_ranks_rank(shard, remap_cases, deepfm, entry, writes):
    """Everything of tests/test_torch_port_zch_ranks.py in one spawn."""
    return ([zch_remap_case(shard, *c) for c in remap_cases],
            zch_deepfm_steps(shard, *deepfm), zch_spill_mirror(shard),
            zch_entry_points(shard, *entry),
            write_logical_rows_case(shard, *writes),
            zch_restore_routing(shard))


WRITE_LAYOUTS = ("row_wise", "column_wise", "table_wise", "data_parallel")


def write_logical_rows_case(shard, canon, ids, rows):
    """Per layout (packed where it packs): the engine tables after every
    rank passes the same ``write_logical_rows`` of logical rows ``ids``
    of table ``t_a`` (each rank writes what it holds), gathered whole;
    and this rank's kernel #3 calls (the plain row write on the CPU)."""
    from torcheasyrec_tpu_torch.ops import row_write

    calls = []
    real = row_write.write_rows

    def counted(table, i, r):
        calls.append(int(i.shape[0]))
        return real(table, i, r)

    out = {}
    row_write.write_rows = counted
    try:
        for layout in WRITE_LAYOUTS:
            eng = port_engine("rowwise_adagrad", {"lr": 0.1}, layout, True,
                              shard)
            tables = eng.init_tables(torch.Generator().manual_seed(0))
            for name, w in canon.items():
                eng.write_table(tables, name, torch.from_numpy(w))
            gk, off, _ = eng.table_rows("t_a")
            del calls[:]
            eng.write_logical_rows(tables[gk], eng.groups[gk],
                                   torch.from_numpy(ids) + off,
                                   torch.from_numpy(rows))
            out[layout] = ({n: eng.extract_table(tables, n).numpy()
                            for n, _, _ in ENGINE_TABLES},
                           eng.groups[gk].packed, list(calls))
    finally:
        row_write.write_rows = real
    return out


# --- the training loop's overlaps over ranks ---------------------------------


def staged_lookup_case(shard, canon, steps, packed):
    """``run_engine``'s steps on an all-``row_wise`` engine twice: inline,
    then with each step's lookup taking the route that the step before
    staged for it (``stage_route`` of the next batch, between the lookup
    and the update, as the train step calls it). Returns (inline result,
    staged result, the groups staged at each step, the owner routes the
    staged run's lookups computed themselves)."""
    import threading

    half = ENGINE_B // shard.world
    rows = slice(shard.rank * half, (shard.rank + 1) * half)
    out = []
    staged_groups, inline_routes = [], []
    for staging in (False, True):
        eng = port_engine("adagrad", {"lr": 0.1}, "row_wise", packed, shard)
        if staging:
            real_route = eng._owner_route

            def route(g, flat_ids, sh=None):
                if threading.current_thread() is threading.main_thread():
                    inline_routes.append(int(flat_ids.shape[0]))
                return real_route(g, flat_ids, sh)

            eng._owner_route = route
        tables = eng.init_tables(torch.Generator().manual_seed(0))
        for name, w in canon.items():
            eng.write_table(tables, name, torch.from_numpy(w))
        state = eng.init_opt_state()
        outs, pending = [], None
        for i, (batch, grads) in enumerate(steps):
            sparse, seq = port_fields(batch, rows)
            o, res = eng.lookup(tables, sparse, seq, staged=pending)
            pending = None
            if staging and i + 1 < len(steps):
                pending = eng.stage_route(*port_fields(steps[i + 1][0], rows))
                staged_groups.append(sorted(pending.wait()))
            outs.append({k: v.float().numpy() for k, v in o.items()})
            eng.update(tables, state, res,
                       {k: torch.from_numpy(g[rows]) for k, g in grads.items()},
                       0.5)
        weights = {n: eng.extract_table(tables, n).numpy()
                   for n, _, _ in ENGINE_TABLES}
        st = {n: {k: v.numpy() for k, v in
                  eng.extract_table_state(tables, state, n).items()}
              for n, _, _ in ENGINE_TABLES}
        out.append((outs, weights, st))
    groups = {gk: (g.sharding, g.packed) for gk, g in eng.groups.items()}
    return out[0], out[1], staged_groups, groups, len(inline_routes)


def zch_stage_case(shard):
    """An EmbeddingGroup of a ZCH feature (dim 8) and a plain one (dim
    16), both ``row_wise``: the groups ``stage_route`` stages, the group
    of each table, and the lookup with the staged route against the
    inline one after the remap."""
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField
    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    feats = create_features([text_format.Parse(t, feature_pb2.FeatureConfig())
                             for t in (
        "id_feature { feature_name: 'z' embedding_dim: 8 "
        "zch { zch_size: 64 lfu {} } }",
        "id_feature { feature_name: 'p' num_buckets: 300 "
        "embedding_dim: 16 }")])
    mc = text_format.Parse('feature_groups { group_name: "g" '
                           'feature_names: "z" feature_names: "p" '
                           'group_type: DEEP }', model_pb2.ModelConfig())
    eg = EmbeddingGroup(feats, list(mc.feature_groups), torch.Generator(),
                        shard=shard, plan={"z_emb": "row_wise",
                                           "p_emb": "row_wise"})
    r = np.random.default_rng(5 + shard.rank)
    batch = Batch(sparse_features={
        "z": SparseField(torch.from_numpy(
            r.integers(0, 10 ** 6, (6, 1)).astype(np.int64))),
        "p": SparseField(torch.from_numpy(
            r.integers(0, 300, (6, 2)).astype(np.int32)))})
    staged = eg.stage_route(batch)
    remapped, _ = eg.remap_zch(batch, 0, True)
    out_s, _ = eg.lookup(remapped, staged=staged)
    out_i, _ = eg.lookup(remapped)
    tables = {t: eg.engine._table_group[t] for t in ("z_emb", "p_emb")}
    return (sorted(staged.wait()), tables,
            {k: v.numpy() for k, v in out_s.items()},
            {k: v.numpy() for k, v in out_i.items()})


def pipelined_train_case(shard, cfg_text, canon, steps_cols, labels, plan):
    """``train_case``'s steps through the loop's ``train_epoch``, once
    unpipelined and once pipelined (each step given the next batch).
    Returns per run (state_dict, sparse optimizer state per table, losses
    per step, whether each step staged a route)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.datasets.utils import BatchInfo
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(cfg_text)
    out = []
    for pipelined in (False, True):
        model, features, sparse_sched = port_main._build_model_and_optim(
            cfg, "cpu", for_train=True, shard=shard, plan=plan)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in canon.items()})
        tx, dense_sched = port_main._dense_optimizer(model, cfg.train_config)
        state = port_main._init_state(model, tx)
        eg = model.embedding_group
        staged, real_stage = [], eg.stage_route

        def stage(batch):
            handle = real_stage(batch)
            staged.append(handle is not None)
            return handle

        eg.stage_route = stage
        step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
        losses = []

        def recorded(state, *batches):
            state, metrics = step(state, *batches)
            losses.append(float(metrics["total_loss"]))
            return state, metrics

        parser = DataParser(features, labels=labels)
        items = [(parser.parse_to_batch(_local_cols(c, shard.rank,
                                                    shard.world)),
                  BatchInfo(batch_size=len(c[labels[0]]) // shard.world))
                 for c in steps_cols]
        state, _, _ = port_main.train_epoch(recorded, state, items, {},
                                            shard=shard, pipelined=pipelined)
        sd = {k: v.detach().float().numpy()
              for k, v in model.state_dict().items()}
        opt = {n: {k: v.float().numpy() for k, v in st.items()}
               for n, st in eg.opt_state_dict(state["sparse_opt"]).items()}
        out.append((sd, opt, losses, staged))
    return out


def overlap_loop_rank(shard, cfg_paths, resume_at):
    """``train_and_evaluate`` of each config ({name: path}); a name ending
    in ``_resumed`` runs to step ``resume_at``, then ``continue_train``
    to its end. Returns {name: results}, and per name the calls to
    ``EmbeddingGroup.stage_route`` that staged a route."""
    import json

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup

    real = EmbeddingGroup.stage_route
    staged = []

    def counted(self, batch):
        handle = real(self, batch)
        staged.append(handle is not None)
        return handle

    EmbeddingGroup.stage_route = counted
    out, stages = {}, {}
    try:
        for name, path in cfg_paths.items():
            del staged[:]
            if name.endswith("_resumed"):
                first = port_main.train_and_evaluate(
                    path, device="cpu", shard=shard,
                    edit_config_json=json.dumps(
                        {"train_config.num_steps": resume_at}))
                again = port_main.train_and_evaluate(
                    path, device="cpu", shard=shard, continue_train=True)
                out[name] = (first, again)
            else:
                out[name] = port_main.train_and_evaluate(path, device="cpu",
                                                         shard=shard)
            stages[name] = list(staged)
    finally:
        EmbeddingGroup.stage_route = real
    return out, stages


class _StubEvalModel:
    """What ``_run_eval_ranks`` reads of a model: one AUC metric over the
    rows of the batches fed to it."""

    def init_metrics(self):
        from torcheasyrec_tpu_torch.metrics import AUC

        return [{"name": "auc", "metric": AUC()}]

    def update_metrics(self, metrics, preds, batch):
        metrics[0]["metric"].update(preds["p"], batch["y"])

    def compute_metrics(self, metrics):
        return {m["name"]: m["metric"].compute() for m in metrics}


class _ListLoader:
    def __init__(self, items):
        self._it = iter(items)

    def __next__(self):
        return next(self._it)

    def close(self):
        pass


def eval_decision_rank(shard, batches_per_rank):
    """``main._run_eval_ranks`` with a stub model and eval step, rank r
    fed ``batches_per_rank[case][r]`` ({"p", "y"} arrays) for each case.
    Returns per case (steps run, the result)."""
    from torcheasyrec_tpu_torch import main as port_main

    out = []
    for per_rank in batches_per_rank:
        mine = per_rank[shard.rank]
        steps = []

        def eval_step(batch):
            steps.append(1)
            return {"p": batch["p"]}, {"l": torch.tensor(0.5)}

        result = port_main._run_eval_ranks(
            _StubEvalModel(), eval_step,
            lambda: _ListLoader([(b, None) for b in mine]), 0, shard)
        out.append((len(steps), result))
    return out


def pipeline_file_rank(shard, engine, train, loop, decisions):
    """Everything of tests/test_torch_port_pipeline.py that runs on the
    ranks, in one spawn."""
    canon, steps = engine
    return ([staged_lookup_case(shard, canon, steps, p) for p in (True, False)],
            zch_stage_case(shard), pipelined_train_case(shard, *train),
            overlap_loop_rank(shard, *loop),
            eval_decision_rank(shard, decisions))


# --- reductions over the global batch ------------------------------------------


def reduction_case(shard, cfg_text, canon, steps_cols, labels, plan,
                   eval_cols=None, dump_dir=None):
    """The train steps of the port from the state_dict ``canon``, each on
    this process's columns of a global batch (``steps_cols``: one rank's,
    or the whole batch without ``shard``); a model that collects samples
    collects each batch and fits at the end. With ``eval_cols`` the eval
    metrics of that batch, gathered from the ranks; with ``dump_dir`` a
    delta dump every 2 steps and at the end. Returns (state_dict, sparse
    optimizer state per table, losses per step, eval metrics)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.metrics import sync_metrics
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config
    from torcheasyrec_tpu_torch.utils.delta_embedding_dump import (
        DeltaEmbeddingDumper,
    )

    cfg = parse_pipeline_config(cfg_text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, shard=shard, plan=plan)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in canon.items()})
    tx, dense_sched = port_main._dense_optimizer(model, cfg.train_config)
    state = port_main._init_state(model, tx)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    parser = DataParser(features, labels=labels)
    dumper = None if dump_dir is None else DeltaEmbeddingDumper(
        dump_dir, model.embedding_group, 2)
    losses = []
    for cols in steps_cols:
        batch = parser.parse_to_batch(cols)
        state, metrics = step(state, batch)
        losses.append(float(metrics["total_loss"]))
        if hasattr(model, "collect_from_batch"):
            model.collect_from_batch(batch)
        if dumper is not None:
            dumper.observe(batch)
            dumper.maybe_dump(state["step"],
                              model.embedding_group.engine_tables())
    if dumper is not None:
        dumper.dump(state["step"], model.embedding_group.engine_tables())
    if hasattr(model, "on_train_end"):
        model.on_train_end()
    result = {}
    if eval_cols is not None:
        batch = parser.parse_to_batch(eval_cols)
        preds, _ = port_main.make_eval_step(model)(batch)
        ms = model.init_metrics()
        model.update_metrics(ms, preds, batch)
        sync_metrics(ms, shard)
        result = model.compute_metrics(ms)
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    opt = {n: {k: v.float().numpy() for k, v in st.items()}
           for n, st in model.embedding_group.opt_state_dict(
               state["sparse_opt"]).items()}
    return sd, opt, losses, result


def mesh_helpers_case(shard, x, parts):
    """``mesh.logsumexp_rows`` of this rank's rows of ``x`` (an even split
    of the global rows) with the gradient of the sum of its outputs
    weighted by row, and ``mesh.gather_host_steps`` of this rank's
    ``parts`` (``parts[rank]``: its buffers step by step)."""
    from torcheasyrec_tpu_torch.parallel import mesh

    per = x.shape[0] // shard.world
    xt = torch.from_numpy(x[shard.rank * per:(shard.rank + 1) * per].copy())
    xt.requires_grad_(True)
    lse = mesh.logsumexp_rows(xt, shard)
    w = torch.arange(1, lse.shape[1] + 1, dtype=lse.dtype)
    (lse * w).sum().backward()
    return (lse.detach().numpy(), xt.grad.numpy(),
            mesh.gather_host_steps(parts[shard.rank], shard))


def dump_loop_rank(shard, cfg_path):
    """``train_and_evaluate`` with a delta dump, on this rank's file."""
    from torcheasyrec_tpu_torch import main as port_main

    return port_main.train_and_evaluate(cfg_path, device="cpu", shard=shard)


def global_reductions_rank(shard, cases, helpers, loop_cfg):
    """Everything of tests/test_torch_port_global_reductions.py that runs
    on the ranks, in one spawn: each case's ``reduction_case`` on this
    rank's columns, the mesh helpers and the loop with the dump."""
    out = {}
    for name, (text, canon, per_rank, labels, plan, evals, dump) in \
            cases.items():
        out[name] = reduction_case(
            shard, text, canon, per_rank[shard.rank], labels, plan,
            None if evals is None else evals[shard.rank],
            None if dump is None else f"{dump}/rank_{shard.rank}")
    return (out, mesh_helpers_case(shard, *helpers),
            dump_loop_rank(shard, loop_cfg))

"""What the ranks of the multi-process port tests run: importable by
name from a spawned process, and free of JAX (the parent process holds
the JAX references). Each function takes the rank's ``ShardContext``
first, as ``dist_util.spawn_ranks`` calls it, and returns numpy arrays.
"""

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


# --- entry points and refusals ------------------------------------------------


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
    """The train-step cases, the entry points and the refusals, in one
    spawn."""
    return (train_cases_rank(shard, train_cases),
            entry_points_rank(shard, cfg_path, more_steps),
            refusals_rank(shard, cfg_texts))

"""The port's sharded embedding engine and planner against the JAX
package's, on the CPU.

Planner: ``create_plan`` of the port equals the JAX package's on the
same table specs and environment (every variable set explicitly), for 1,
2, 4 and 8 devices, with constraints, and both raise ``PlanError`` on a
budget no plan fits. No processes.

Engine: two ranks (gloo, spawned once for the module, ``FileStore``
under ``tmp_path``, 120 s limit) run every layout (``row_wise``,
``column_wise``, ``table_wise``, ``table_row_wise``, ``data_parallel``)
with adagrad, rowwise adagrad and adam (eps 1e-4, ROADMAP §3), packed
and unpacked: lookups of each rank's half of a batch, then 3 updates
whose ids change every step and collide across the ranks. Each case
is held against the JAX engine on a 2-device mesh from the same tables
and gradients and against the port at world size 1: lookups, tables
and row state (through ``extract_table[_state]``) within 1e-5 of each
tensor's max; replicated and gathered tables equal on both ranks. The
same spawn draws every layout's init from one seed, the small tables
from the model's generator and the large ones by chunk: each rank's rows
equal, bit for bit, what one rank draws. It also runs the co-keyed merge
over the ranks: a WIDE/DEEP pair merged into one group (``d20_<layout>
_s16.4``, rowwise adagrad, packed) in the ``row_wise``, ``table_wise``,
``table_row_wise`` and ``data_parallel`` layouts, each with the group
keys of the JAX engine on a 2-device mesh with its merge on (its
default), within 1e-5 of that engine and of the merged one-rank run;
and the ``row_wise`` run's per-table state (what a checkpoint holds)
restored exactly into an unmerged one-rank engine.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheasyrec_tpu.datasets.utils import SparseField as JaxField
from torcheasyrec_tpu.parallel import emb_engine as jax_engine
from torcheasyrec_tpu.parallel import planner as jax_planner
from torcheasyrec_tpu.parallel.mesh import create_mesh
from torcheasyrec_tpu.parallel.sparse_optim import (
    SparseOptimizer as JaxSparseOptimizer,
)
from torcheasyrec_tpu_torch.parallel import emb_engine as port_engine_mod
from torcheasyrec_tpu_torch.parallel import planner as port_planner
from torcheasyrec_tpu_torch.utils import dist_util

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_dist_ranks as R  # noqa: E402
from torch_port_helpers import assert_close_to_max  # noqa: E402

TOL = 1e-5
ADAM = {"lr": 0.01, "eps": 1e-4}
CASES = [
    ("row_wise", "adagrad", {"lr": 0.1}, True),
    ("row_wise", "rowwise_adagrad", {"lr": 0.1}, False),
    ("row_wise", "adam", ADAM, True),
    ("column_wise", "rowwise_adagrad", {"lr": 0.1}, False),
    ("column_wise", "adam", ADAM, False),
    ("table_wise", "adam", ADAM, True),
    ("table_wise", "rowwise_adagrad", {"lr": 0.1}, False),
    ("table_row_wise", "adagrad", {"lr": 0.1}, True),
    ("data_parallel", "rowwise_adagrad", {"lr": 0.1}, False),
    ("data_parallel", "adam", ADAM, False),
]
CASE_IDS = [f"{l}-{k}-{'packed' if p else 'unpacked'}"
            for l, k, _, p in CASES]
# (layout, chunk): tables up to ``chunk`` rows are drawn from the model's
# generator in a one-rank engine's order, larger ones by chunk; 64 puts
# t_a and t_d (and a chunk boundary inside each rank's rows) on that side
INIT_CASES = [(layout, chunk)
              for layout in ("row_wise", "column_wise", "table_wise",
                             "data_parallel")
              for chunk in (4 << 20, 64)]

# --- planner -------------------------------------------------------------

PLAN_ENV = {
    "INTRA_NODE_BANDWIDTH": "4.5e11", "CROSS_NODE_BANDWIDTH": "5e10",
    "HOST_LINK_BANDWIDTH": "6.4e10", "HBM_BANDWIDTH": "3.35e12",
    "HBM_CAPACITY": "8e9", "DDR_CAPACITY": "64e9",
    "STORAGE_RESERVE_PERCENT": "0.15",
    "COLLECTIVE_LAUNCH_OVERHEAD": "5e-6", "HOST_LINK_LATENCY": "3e-5",
    "TZREC_DISABLE_HOST_OFFLOAD": "0",
}
# (name, rows, dim, constraints): tiny to 7.7 GB, dims that do and do not
# split over the devices
PLAN_TABLES = [
    ("tiny", 100, 16, ()), ("small", 9000, 8, ()),
    ("mid", 2_000_000, 16, ()), ("big", 20_000_000, 64, ()),
    ("huge", 30_000_000, 64, ()), ("odd", 500_000, 12, ()),
    ("forced_cw", 1_000_000, 32, ("column_wise", "data_parallel")),
    ("forced_tw", 300_000, 16, ("table_wise", "data_parallel")),
]


def _specs(mod, tables):
    return [mod.TableSpec(n, r, d, sharding_types=c) for n, r, d, c in tables]


@pytest.mark.parametrize("n_devices,spg", [(1, 1), (2, 2), (4, 2), (8, 4),
                                           (8, 8)])
@pytest.mark.parametrize("opt", ["adagrad", "rowwise_adagrad", "adam"])
def test_plan_matches_jax(n_devices, spg, opt, monkeypatch):
    for k, v in PLAN_ENV.items():
        monkeypatch.setenv(k, v)
    kw = dict(n_devices=n_devices, batch_size=8192, optimizer_kind=opt,
              shards_per_host=spg, avg_ids_per_sample=3.0)
    jplan, jcost, jper = jax_planner.plan_cost(
        _specs(jax_engine, PLAN_TABLES), **kw)
    pplan, pcost, pper = port_planner.plan_cost(
        _specs(port_engine_mod, PLAN_TABLES), **kw)
    assert pplan == jplan
    assert pcost == pytest.approx(jcost, rel=1e-12)
    assert pper == pytest.approx(jper, rel=1e-12)
    assert pplan["forced_cw"] in ("column_wise", "data_parallel")


def test_plan_error_matches_jax(monkeypatch):
    for k, v in PLAN_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HBM_CAPACITY", "1e8")
    monkeypatch.setenv("DDR_CAPACITY", "1e8")
    tables = [("big", 40_000_000, 64, ())]
    with pytest.raises(jax_planner.PlanError):
        jax_planner.create_plan(_specs(jax_engine, tables), n_devices=2,
                                batch_size=1024)
    with pytest.raises(port_planner.PlanError):
        port_planner.create_plan(_specs(port_engine_mod, tables),
                                 n_devices=2, batch_size=1024)
    # a constraint no layout meets at this device count
    bad = [("t", 1000, 12, ("column_wise",))]
    with pytest.raises(port_planner.PlanError):
        port_planner.create_plan(_specs(port_engine_mod, bad), n_devices=8,
                                 batch_size=1024)


def test_plan_defaults_are_the_h100s(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert port_planner._env("HBM_CAPACITY") == 80e9  # no CUDA here
    assert port_planner._env("HBM_BANDWIDTH") == 3.35e12
    assert port_planner._env("INTRA_NODE_BANDWIDTH") == 4.5e11
    assert port_planner._env("HOST_LINK_BANDWIDTH") == 6.4e10


def test_f13_save_plan_is_never_read_half_written(tmp_path):
    """F13: a rank loading ``sharding_plan.json`` while rank 0 rewrites it
    (a continued run) read a truncated file; ``save_plan`` now renames a
    whole file into place, so every load sees the whole plan."""
    import threading

    plan = {f"table_{i}": "row_wise" for i in range(2000)}
    port_planner.save_plan(plan, str(tmp_path))
    stop = threading.Event()

    def rewrite():
        while not stop.is_set():
            port_planner.save_plan(plan, str(tmp_path))

    writer = threading.Thread(target=rewrite)
    writer.start()
    try:
        for _ in range(300):
            assert port_planner.load_plan(str(tmp_path)) == plan
    finally:
        stop.set()
        writer.join()
    assert os.listdir(tmp_path) == ["sharding_plan.json"]


# --- engine: two ranks against the JAX mesh and one rank -------------------


def _steps():
    eng = R.port_engine("sgd", {"lr": 0.1}, "row_wise", True)
    tables = eng.init_tables(torch.Generator().manual_seed(0))
    steps = []
    for i in range(3):
        batch = R.engine_batch(100 + i)
        out, _ = eng.lookup(tables, *R.port_fields(batch))
        steps.append((batch, R.engine_grads(
            {k: v.shape for k, v in out.items()}, 200 + i)))
    return steps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' results, the JAX mesh's and one rank's results per
    case): the references are computed while the ranks run."""
    r = np.random.default_rng(3)
    canon = {n: (r.random((rows, d), np.float32) - 0.5)
             for n, rows, d in R.ENGINE_TABLES}
    steps = _steps()
    job = dist_util.start_ranks(
        R.engine_and_init_rank, 2, (CASES, canon, steps, INIT_CASES,
                                    _merge_inputs()),
        store_dir=str(tmp_path_factory.mktemp("store")), device="cpu",
        timeout_s=120)
    # the JAX engines built one by one (they read the environment), then
    # run in threads, one a case, so that their compiles overlap
    merge_canon, merge_steps = _merge_inputs()
    with pytest.MonkeyPatch.context() as mp:
        jengs = [_jax_engine(l, k, c, p, mp) for l, k, c, p in CASES]
        merged = [_jax_engine(l, *R.MERGE_OPT, True, mp, R.MERGE_TABLES,
                              R.MERGE_LOOKUPS, merge=True)
                  for l in R.MERGE_LAYOUTS]
    with ThreadPoolExecutor(len(CASES) + len(merged)) as pool:
        jax_refs = [pool.submit(_jax_case, jeng, canon, steps)
                    for jeng in jengs]
        jax_merged = [pool.submit(_jax_case, jeng, merge_canon, merge_steps,
                                  R.MERGE_TABLES) for jeng in merged]
        ones = [R.run_engine(R.port_engine(k, c, l, p), canon, steps)
                for l, k, c, p in CASES]
        one_merged = [R.run_engine(R.merge_engine(layout=l), merge_canon,
                                   merge_steps, tables=R.MERGE_TABLES)
                      for l in R.MERGE_LAYOUTS]
        refs = [(f.result(), one) for f, one in zip(jax_refs, ones)]
        merged_refs = {l: (sorted(jeng.groups), f.result(), one)
                       for l, jeng, f, one in zip(
                           R.MERGE_LAYOUTS, merged, jax_merged, one_merged)}
    return job.wait(), refs, merged_refs


def _jax_engine(layout, kind, cfg, packed, monkeypatch,
                tables=R.ENGINE_TABLES, lookups=R.ENGINE_LOOKUPS,
                merge=False):
    """The JAX engine of a case on a 2-device mesh, unmerged (the layout
    comparison is of plain groups) unless ``merge``."""
    monkeypatch.setenv("TZREC_TABLE_MERGE", "1" if merge else "0")
    monkeypatch.setenv("TZREC_PACKED", "1" if packed else "0")
    mesh = create_mesh(jax.devices()[:2])
    return jax_engine.EmbeddingEngine(
        [jax_engine.TableSpec(n, r, d, sharding=layout)
         for n, r, d in tables],
        [jax_engine.LookupSpec(k, f, t, c, s) for k, f, t, c, s in lookups],
        mesh=mesh, optimizer=JaxSparseOptimizer(kind, cfg))


def _jax_case(jeng, canon, steps, specs=R.ENGINE_TABLES):
    # zero tables (the optimizers' fills are 0), overwritten from
    # ``canon``: the engine's own init compiles a generator per group
    tables = {gk: jeng._device_put_table(
        jnp.zeros((g.p_rows, 128) if g.packed else (g.padded_rows, g.dim)),
        g) for gk, g in jeng.groups.items()}
    state = jeng.init_opt_state()
    tables, state = jeng.from_canonical(
        {n: {"weight": w} for n, w in canon.items()}, tables, state)
    look = jax.jit(lambda t, s, q: jeng.lookup(t, s, q))
    upd = jax.jit(lambda t, s, r, g: jeng.update(t, s, r, g,
                                                 jnp.float32(0.5)))
    outs = []
    for batch, grads in steps:
        sparse = {k: JaxField(jnp.asarray(v.astype(np.int32)))
                  for k, (v, _) in batch.items() if k != "f_s"}
        seq = {k: JaxField(jnp.asarray(v.astype(np.int32)),
                           lengths=jnp.asarray(lengths))
               for k, (v, lengths) in batch.items() if k == "f_s"}
        out, res = look(tables, sparse, seq)
        outs.append({k: np.asarray(o) for k, o in out.items()})
        tables, state = upd(tables, state, res,
                            {k: jnp.asarray(g) for k, g in grads.items()})
    weights = {n: np.asarray(jeng.extract_table(tables, n))
               for n, _, _ in specs}
    st = {n: {k: np.asarray(v) for k, v in
              jeng.extract_table_state(tables, state, n).items()}
          for n, _, _ in specs}
    return outs, weights, st


def _assert_result(got_ranks, ref, name):
    """The ranks' concatenated lookups and rank 0's tables and state
    within TOL of ``ref``; every rank's tables equal rank 0's."""
    ref_outs, ref_w, ref_st = ref[:3]
    for step, ro in enumerate(ref_outs):
        for k, v in ro.items():
            got = np.concatenate([g[0][step][k] for g in got_ranks])
            assert_close_to_max(got, v, f"{name} step {step} {k}", TOL)
    w0, st0 = got_ranks[0][1], got_ranks[0][2]
    for n, v in ref_w.items():
        assert_close_to_max(w0[n], v, f"{name} {n}", TOL)
        for k, sv in ref_st[n].items():
            sv = np.asarray(sv)
            assert_close_to_max(np.asarray(st0[n][k]).reshape(sv.shape), sv,
                                f"{name} {n}.{k}", TOL)
        for g in got_ranks[1:]:
            np.testing.assert_array_equal(g[1][n], w0[n])


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_layout_matches_jax_mesh_and_one_rank(case, ranks):
    out, refs, _ = ranks
    got = [rank_out[0][case] for rank_out in out]
    jax_ref, one_rank = refs[case]
    _assert_result(got, jax_ref, f"jax {CASE_IDS[case]}")
    _assert_result(got, one_rank, f"world 1 {CASE_IDS[case]}")


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_read_rows_and_row_state_equal_the_extracted(case, ranks):
    """``read_rows`` and ``read_row_state`` at some rows, on every rank
    of every layout, equal those rows of the gathered table and state."""
    out, _, _ = ranks
    for rank_out in out:
        _, w, st, reads = rank_out[0][case]
        for n, rows, _ in R.ENGINE_TABLES:
            got_w, got_st = reads[n]
            probe = np.arange(0, rows, 3)
            np.testing.assert_array_equal(got_w, w[n][probe])
            want = {k: np.asarray(v) for k, v in st[n].items()
                    if np.ndim(v) >= 1}
            assert set(got_st) == set(want), (set(got_st), set(want))
            for k, v in want.items():
                np.testing.assert_array_equal(
                    got_st[k], v.reshape(rows, -1)[probe], f"{n}.{k}")


def test_spawn_defaults_to_the_card(monkeypatch):
    """Without a device the ranks are asked for a card: no CUDA raises
    before any rank is spawned (``device="cpu"`` runs them on the
    host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_util.start_ranks(R.init_rank, 2, ([],))


def test_duplicate_sums_run_left_to_right_in_id_order():
    """The engine sums a row's gradients in the order they came, left to
    right, with no atomic adds and no process-wide flag: bit-equal to a
    sequential sum; the dense lane's region likewise."""
    Eng = port_engine_mod.EmbeddingEngine
    r = np.random.default_rng(5)
    ids = torch.from_numpy(r.integers(-1, 9, 400))
    grads = torch.from_numpy(
        (r.normal(size=(400, 3)) * 10.0 ** r.integers(-6, 6, (400, 1)))
        .astype(np.float32))
    uids, gsum = Eng._dedup(ids, grads, 8)
    assert not torch.are_deterministic_algorithms_enabled()
    want_ids = sorted({int(i) for i in ids if 0 <= i < 8})
    assert uids.tolist() == want_ids
    for u, got in zip(want_ids, gsum):
        acc = torch.zeros(3)
        for i in np.nonzero(ids.numpy() == u)[0]:
            acc = acc + grads[i]
        assert torch.equal(got, acc), u
    region = port_engine_mod._sorted_segment_sum(
        grads, torch.argsort(ids.clamp(min=-1) % 9, stable=True),
        torch.bincount(ids.clamp(min=-1) % 9, minlength=10))
    assert region.shape == (10, 3)
    assert torch.equal(region[:8], torch.zeros(8, 3).index_put_(
        (uids,), gsum))
    empty = Eng._dedup(torch.full((4,), -1), torch.ones(4, 3), 8)
    assert empty[0].shape == (0,) and empty[1].shape == (0, 3)


def _merge_inputs():
    """(canon, steps) of the merge case."""
    r = np.random.default_rng(4)
    canon = {n: (r.random((rows, d), np.float32) - 0.5)
             for n, rows, d in R.MERGE_TABLES}
    steps = []
    for i in range(3):
        batch = R.merge_batch(300 + i)
        steps.append((batch, R.engine_grads(
            {"md": (R.ENGINE_B, 16), "mw": (R.ENGINE_B, 4),
             "c": (R.ENGINE_B, 8)}, 400 + i)))
    return canon, steps


def test_merged_row_wise_matches_the_merged_one_rank_run(ranks):
    out, _, merged_refs = ranks
    for rank_out in out:
        assert rank_out[2]["row_wise"][1]["d20_row_wise_s16.4"] == "row_wise"
    _assert_result([rank_out[2]["row_wise"][0] for rank_out in out],
                   merged_refs["row_wise"][2], "merged row_wise")


@pytest.mark.parametrize("layout", R.MERGE_LAYOUTS)
def test_merged_layout_matches_jax_mesh_and_one_rank(layout, ranks):
    """The merge case in ``layout`` at world size 2: the JAX mesh
    engine's group keys (the WIDE/DEEP pair in one ``_s16.4`` group of
    the resolved layout), and
    lookups, tables and row state within TOL of that engine (merge on)
    and of the merged one-rank run."""
    out, _, merged_refs = ranks
    jax_keys, jax_ref, one_rank = merged_refs[layout]
    for rank_out in out:
        keys = rank_out[2][layout][1]
        assert sorted(keys) == jax_keys
        merged = [k for k in keys if k.endswith("_s16.4")]
        assert merged == [f"d20_{keys[merged[0]]}_s16.4"], keys
    got = [rank_out[2][layout][0] for rank_out in out]
    _assert_result(got, jax_ref, f"jax merged {layout}")
    _assert_result(got, one_rank, f"world 1 merged {layout}")


@pytest.mark.parametrize("packed", [True, False])
def test_merged_checkpoint_restores_into_an_unmerged_one_rank_engine(
        packed, ranks):
    """Rank 0's gathered tables and row state after the world-2 merged
    run, as a checkpoint holds them by original name, written into an
    unmerged one-rank engine read back bit for bit."""
    out, _, _ = ranks
    _, weights, st, _ = out[0][2]["row_wise"][0]
    eng = R.merge_engine(merge=False, packed=packed)
    assert not eng._merged
    tables = eng.init_tables(torch.Generator().manual_seed(9))
    state = eng.init_opt_state()
    for n, _, _ in R.MERGE_TABLES:
        eng.write_table(tables, n, torch.from_numpy(weights[n]))
        eng.write_table_state(tables, state, n, {
            k: torch.from_numpy(np.asarray(v)) for k, v in st[n].items()})
    for n, rows, d in R.MERGE_TABLES:
        np.testing.assert_array_equal(eng.extract_table(tables, n).numpy(),
                                      weights[n])
        got = eng.extract_table_state(tables, state, n)
        assert set(got) == set(st[n])
        for k, v in st[n].items():
            assert got[k].shape == (rows, 1)
            np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("case", INIT_CASES, ids=[f"{l}-{c}"
                                                  for l, c in INIT_CASES])
def test_sharded_init_equals_one_rank(case, ranks):
    out, _, _ = ranks
    ref = R.init_tables_of(*case)
    for n, _, _ in R.ENGINE_TABLES:
        for rank_out in out:
            np.testing.assert_array_equal(rank_out[1][case][n], ref[n])

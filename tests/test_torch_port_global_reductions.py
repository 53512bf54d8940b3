"""The reductions over the global batch at world size 2 against the JAX
package on a 2-device mesh, on the CPU (gloo; one spawn of two ranks for
the whole file, the JAX runs and the port's one-rank runs in this
process while the ranks run).

Each case trains the port at world size 2, each rank on its half of
every global batch, from the JAX package's initial weights, against the
JAX ``make_train_step`` on the whole batch on ``create_mesh(
jax.devices()[:2])``, and against the port's own one-rank steps on the
same global batches: jrc_loss's session matrix (a DeepFM head and
DBMTL's task towers), MIND's interest attention over every rank's item
rows, HSTU-Match's jagged candidates against every rank's shared
negatives, RQ-VAE's Sinkhorn assignment and its contrastive loss, and
RQ-KMeans' fit on every rank's samples in global batch order (capped
inside a step). A retrieval batch's item rows are, on a rank, [its
positives | its sampled negatives], and on the JAX mesh [every rank's
positives | every rank's negatives]. Dense weights, tables and row state
within 1e-5 of each tensor's max after 3 steps (HSTU-Match 1e-4; MIND
against the JAX package 1e-4, the retrieval tests' step tolerance);
every rank's state_dict equal to rank 0's.

The delta embedding dump at world size 2 writes, from rank 0 alone, the
JAX dumper's files (names, ids, rows) under ``row_wise`` and
``table_wise``; ``train_and_evaluate`` at world size 2 with the dump
writes the files of a one-rank run over the same global batches. The
eval metrics gathered at world size 2 (AUC, recall@k) equal the JAX
package's on the whole batch. ``mesh.logsumexp_rows`` and
``mesh.gather_host_steps`` at world sizes 1 and 2 against their
one-tensor formulas.
"""

import glob
import os
import sys
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.optim.optimizer_builder import create_dense_optimizer
from torcheasyrec_tpu.parallel.mesh import create_mesh
from torcheasyrec_tpu.protos import pipeline_pb2
from torcheasyrec_tpu.utils.delta_embedding_dump import (
    DeltaEmbeddingDumper as JaxDumper,
)
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.parallel import mesh
from torcheasyrec_tpu_torch.utils import dist_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_dist_ranks as R  # noqa: E402
from test_hstu_match import CONFIG as HSTU_MATCH_CONFIG  # noqa: E402
from test_hstu_match import _gen_data  # noqa: E402
from test_torch_port_match import (  # noqa: E402
    N_ITEMS,
    match_cols,
    match_config_text,
)
from test_torch_port_sid import (  # noqa: E402
    CONTRASTIVE,
    RQVAE,
    sid_cols,
    sid_config_text,
)
from torch_port_helpers import (  # noqa: E402
    assert_close_to_max,
    DEEPFM_BUCKETS,
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    zoo_cols,
    zoo_config_text,
    zoo_table_names,
)

TOL = 1e-5
HSTU_TOL = 1e-4
WORLD = 2
GLOBAL_B = 16
N_STEPS = 3
N_NEG = 4  # the sampled negatives of a rank's batch
ADAM = "adam_optimizer { lr: 0.01 eps: 1e-4 } constant_learning_rate {}"
KMEANS_CAP = 40  # inside step 3's rows: rank 0's part of it counts

# --- the configs and the global batches -----------------------------------------


def _halves(cols, neg=(), n_neg=0):
    """Each rank's columns of a global batch: its half of the user-side
    rows; of the item-side columns ``neg`` ([B positives | every rank's
    ``n_neg`` negatives]) its positives, then its negatives."""
    n = len(next(c for k, c in cols.items() if k not in neg))
    per = n // WORLD
    out = []
    for r in range(WORLD):
        out.append({k: (pa.concat_arrays([v.slice(r * per, per),
                                          v.slice(n + r * n_neg, n_neg)])
                        if k in neg else v.slice(r * per, per))
                    for k, v in cols.items()})
    return out


# the DeepFM's first three Criteo features (cat_2, jrc_loss's sessions,
# has 7 ids)
BUCKETS = DEEPFM_BUCKETS[:3]


def _deepfm_cols(n, seed):
    cols = deepfm_cols(n, seed)
    for i in range(len(BUCKETS), len(DEEPFM_BUCKETS)):
        cols.pop(f"cat_{i}")
    return cols


def _deepfm_tables():
    return deepfm_table_names(buckets=BUCKETS)


def _deepfm_jrc_text():
    text = deepfm_config_text(batch_size=GLOBAL_B, dense_opt=ADAM,
                              buckets=BUCKETS)
    return text.replace(
        "  num_class: 1\n  losses { binary_cross_entropy {} }",
        '  num_class: 2\n  losses { jrc_loss { session_name: "cat_2" } }')


def _dbmtl_jrc_text():
    text = zoo_config_text("dbmtl_jrc", batch_size=GLOBAL_B)
    return text.replace("adam_optimizer { lr: 0.001 }",
                        "adam_optimizer { lr: 0.01 eps: 1e-4 }")


_MATCH_FILES = {"items": "x", "pos": "x", "hard": "x"}


def _mind_cols(n, seed):
    """Retrieval columns of ``n`` users, their item columns followed by
    every rank's ``N_NEG`` sampled negatives; the histories' lengths
    those of seed 0's batch in every batch (one JAX compile)."""
    cols = match_cols(n, seed)
    lengths = [len(s.split(";")) for s in
               match_cols(n, 0)["click_seq"].to_pylist()]
    cols["click_seq"] = pa.array([
        ";".join((s.split(";") * k)[:k]) for s, k in
        zip(cols["click_seq"].to_pylist(), lengths)])
    for k in ("user_aug", "item_aug"):
        cols.pop(k)
    neg = np.random.default_rng(seed + 500).integers(0, N_ITEMS,
                                                     WORLD * N_NEG)
    cols["item_id"] = pa.concat_arrays([cols["item_id"], pa.array(neg)])
    cols["item_cluster"] = pa.concat_arrays([cols["item_cluster"],
                                             pa.array(neg // 10)])
    return cols


def _hstu_match_text():
    text = HSTU_MATCH_CONFIG.format(train="x", eval="x", model_dir="x",
                                    item_table="x")
    text = text.replace("input_dropout_ratio: 0.1",
                        "input_dropout_ratio: 0.0")
    return text.replace("num_layers: 2", "num_layers: 1")


HSTU_B = 8  # HSTU-Match's global batch


def _hstu_rows(root):
    """The JAX test's HSTU-Match rows (``_gen_data``)."""
    train, _, _ = _gen_data(root, n_rows=512)
    tbl = pq.read_table(train)
    return {k: tbl.column(k).combine_chunks() for k in tbl.column_names}


def _hstu_cols_fn(rows):
    """Batches of the first ``n`` rows (one JAX compile), each with
    negatives of its own."""
    def cols(n, seed):
        out = {k: v.slice(0, n) for k, v in rows.items()}
        neg = np.random.default_rng(seed).integers(0, 256, WORLD * N_NEG)
        out["cand_seq__video_id"] = pa.concat_arrays([
            out["cand_seq__video_id"], pa.array([str(i) for i in neg])])
        return out
    return cols


def _sinkhorn_text():
    return sid_config_text(RQVAE.replace(
        "codebook: [16, 16]", "codebook: [16, 16] sinkhorn_config { iters: 3 }"
    ), batch_size=GLOBAL_B)


def _rqkmeans_text():
    return sid_config_text(
        f"sid_rqkmeans {{ codebook: [8, 8] train_sample_size: {KMEANS_CAP} }}",
        batch_size=GLOBAL_B)


MIND_TABLES = ["user_taste_emb", "item_id_emb", "item_cluster_emb"]
HSTU_TABLES = ["user_id_emb", "user_degree_emb", "video_emb"]


def _rows_of(layout, tables):
    return {n: layout for n in tables}


def _layout(layout):
    return _rows_of(layout, _deepfm_tables())


def _cases(tmp):
    """name -> (config text, plan, columns fn (n, seed), labels, table
    names, item-side columns, tolerance, eval, dump)."""
    hstu = _hstu_cols_fn(_hstu_rows(str(tmp)))
    deepfm = _deepfm_jrc_text()
    cat_names = _deepfm_tables()
    mind_neg = ("item_id", "item_cluster")
    return {
        "deepfm_jrc": (deepfm, _layout("row_wise"), _deepfm_cols, ["label"],
                       cat_names, (), TOL, True, True),
        "dbmtl_jrc": (_dbmtl_jrc_text(),
                      _rows_of("row_wise", zoo_table_names("dbmtl_jrc")),
                      zoo_cols, ["label", "conversion"],
                      zoo_table_names("dbmtl_jrc"), (), TOL, False, False),
        "mind": (match_config_text("mind_concat", _MATCH_FILES,
                                   batch_size=GLOBAL_B),
                 _rows_of("row_wise", MIND_TABLES), _mind_cols,
                 ["pos_label"],
                 MIND_TABLES, mind_neg, TOL, True, False),
        "hstu_match": (_hstu_match_text(), _rows_of("row_wise", HSTU_TABLES),
                       hstu, ["cand_seq__action_weight"], HSTU_TABLES,
                       ("cand_seq__video_id",), HSTU_TOL, False, False),
        # no tables: the planner plans nothing
        "sid_sinkhorn": (_sinkhorn_text(), None, sid_cols, ["label"], [],
                         (), TOL, False, False),
        "sid_contrastive": (
            sid_config_text(CONTRASTIVE, batch_size=GLOBAL_B, pair="flag"),
            None, lambda n, s: sid_cols(n, s, pair=True), ["label"], [], (),
            TOL, False, False),
        "sid_rqkmeans": (_rqkmeans_text(), None, sid_cols, ["label"], [], (),
                         TOL, False, False),
        # the dump's port runs under two layouts hold to one JAX run
        "dump_table_wise": (deepfm, _layout("table_wise"), _deepfm_cols,
                            ["label"], cat_names, (), TOL, False, True),
    }


# a case whose JAX run and one-rank run are another's: the same config
# and batches under another plan
SHARED_REF = {"dump_table_wise": "deepfm_jrc"}


def _n(name):
    return HSTU_B if name == "hstu_match" else GLOBAL_B


# --- the JAX package on the mesh ------------------------------------------------


def _jax_setup(text, plan, table_names):
    """The JAX model and train state on a 2-device mesh, and its initial
    weights as a state_dict for the port."""
    cfg = text_format.Parse(text, pipeline_pb2.EasyRecConfig())
    jmesh = create_mesh(jax.devices()[:WORLD])
    model, features, sparse_sched = jax_main._build_model_and_optim(
        cfg, jmesh, plan=plan)
    dense, tables, sparse_opt = jax_main._init_state(model, cfg)
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, dense)
    state = {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
             "dense_opt": tx.init(dense), "step": jnp.zeros((), jnp.int32)}
    canon0 = {k: v.numpy() for k, v in converted_state(
        model, dense, tables, table_names).items()}
    return (model, features, sparse_sched, tx, dense_sched, state,
            jmesh), canon0


def _jax_run(setup, steps_cols, labels, table_names, eval_cols, dump_dir):
    """(state_dict, sparse state per table, losses, eval metrics) of the
    JAX package's steps over the global batches; the sample fit at the
    end; the JAX dumper's files under ``dump_dir``."""
    model, features, sparse_sched, tx, dense_sched, state, jmesh = setup
    step = jax.jit(jax_main.make_train_step(
        model, tx, sparse_sched, dense_sched, jnp.float32))
    parser = JaxParser(features, labels=labels)
    dumper = None if dump_dir is None else JaxDumper(
        dump_dir, model.embedding_group, 2)
    losses = []
    for cols in steps_cols:
        host = parser.parse_to_batch(cols)
        state, metrics, updates = step(
            state, jax_main._shard_batch(host, jmesh), jax.random.key(0))
        if updates:
            state["dense"] = jax_main.apply_state_updates(
                state["dense"], jax.device_get(updates))
        losses.append(float(metrics["total_loss"]))
        if hasattr(model, "collect_from_batch"):
            model.collect_from_batch(host)
        if dumper is not None:
            dumper.observe(host)
            dumper.maybe_dump(int(state["step"]), state["tables"])
    if dumper is not None:
        dumper.dump(int(state["step"]), state["tables"])
    if hasattr(model, "on_train_end"):
        state["dense"] = model.on_train_end(jax.device_get(state["dense"]))
    result = {}
    if eval_cols is not None:
        batch = parser.parse_to_batch(eval_cols)
        preds, _ = jax.jit(jax_main.make_eval_step(model, jnp.float32))(
            {"dense": state["dense"], "tables": state["tables"]},
            jax_main._shard_batch(batch, jmesh))
        ms = model.init_metrics()
        model.update_metrics(ms, jax.device_get(preds), batch)
        result = {m["name"]: m["metric"].compute() for m in ms}
    final = {k: v.numpy() for k, v in converted_state(
        model, state["dense"], state["tables"], table_names).items()}
    eng = model.embedding_group.engine
    opt = {n: {k: np.asarray(v) for k, v in eng.extract_table_state(
        state["tables"], state["sparse_opt"], n).items()}
        for n in table_names}
    return final, opt, losses, result


# --- the loop with the dump -------------------------------------------------------

LOOP_STEPS = 3


def _loop_files(root):
    """(world-2 config path, world-1 config path): a row_wise DeepFM with
    a delta dump every 2 steps; at world 2 each rank reads a file of its
    own (``GLOBAL_B / 2`` rows a batch), at world 1 one file whose
    batches of ``GLOBAL_B`` are the ranks' batches side by side."""
    half = GLOBAL_B // WORLD
    parts = [_deepfm_cols(half * LOOP_STEPS, 70 + r) for r in range(WORLD)]
    paths = []
    for r, cols in enumerate(parts):
        paths.append(str(root / f"rank_{r}.parquet"))
        pq.write_table(pa.table(cols), paths[-1])
    one = {k: pa.concat_arrays([p[k].slice(s * half, half)
                                for s in range(LOOP_STEPS) for p in parts])
           for k in parts[0]}
    pq.write_table(pa.table(one), str(root / "one.parquet"))
    out = []
    for name, batch, train in (("world_2", half, ",".join(paths)),
                               ("world_1", GLOBAL_B,
                                str(root / "one.parquet"))):
        text = deepfm_config_text(
            batch_size=batch, dense_opt=ADAM, num_steps=LOOP_STEPS,
            buckets=BUCKETS,
            model_dir=str(root / name),
            feature_extra='embedding_constraints { sharding_types: '
                          '"row_wise" } ',
            train_extra="  delta_embedding_dump_config "
                        "{ dump_interval_steps: 2 }\n  use_tensorboard: false")
        text = text.replace('train_input_path: "unused"',
                            f'train_input_path: "{train}"')
        text = text.replace('eval_input_path: "unused"',
                            'eval_input_path: ""')
        path = str(root / f"{name}.config")
        with open(path, "w") as f:
            f.write(text)
        out.append(path)
    return out


# --- the mesh helpers ----------------------------------------------------------


def _helper_inputs():
    r = np.random.default_rng(3)
    x = r.normal(size=(6, 5)).astype(np.float32) * 3
    parts = [[r.normal(size=(n, 4)).astype(np.float32) for n in (2, 3, 1)],
             [r.normal(size=(n, 4)).astype(np.float32) for n in (1, 2)]]
    return x, parts


def _helper_refs(x, parts, world):
    """The one-tensor formulas: the logsumexp over all rows; the gradient
    of the sum over the ranks of their losses (each rank's loss reads the
    global logsumexp: ``world`` copies of it); the buffers step by step,
    rank by rank."""
    xt = torch.from_numpy(x)
    lse = torch.logsumexp(xt, dim=0, keepdim=True)
    w = torch.arange(1, x.shape[1] + 1, dtype=torch.float32)
    grad = torch.softmax(xt, dim=0) * w * world
    order = [parts[0][0], parts[1][0], parts[0][1], parts[1][1],
             parts[0][2]]
    return lse.numpy(), grad.numpy(), np.concatenate(order)


# --- the run -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks for the whole file. Returns ({case: (JAX
    result, port one-rank result, [rank results])}, case definitions,
    dump dirs, (mesh helper inputs, [rank results]), (loop config
    paths, [rank results], one-rank result))."""
    tmp = tmp_path_factory.mktemp("global")
    cases = _cases(tmp)
    loop_cfgs = _loop_files(tmp_path_factory.mktemp("loop"))
    helpers = _helper_inputs()
    batches, dumps = {}, {}
    for name, (_, _, cols_fn, _, _, _, _, evals, dump) in cases.items():
        n = _n(name)
        batches[name] = ([cols_fn(n, 10 + i) for i in range(N_STEPS)],
                         cols_fn(n, 90) if evals else None)
        if dump:
            ref = SHARED_REF.get(name, name)
            dumps[name] = {"jax": str(tmp / f"{ref}_jax"),
                           "one": str(tmp / f"{ref}_one"),
                           "port": str(tmp / f"{name}_port")}
    # the cheap setups first: the ranks start once every case has its
    # initial weights
    own = sorted((name for name in cases if name not in SHARED_REF),
                 key=lambda n: not n.startswith("sid"))
    canon = {name: Future() for name in own}
    # the ranks start at once: a case's initial weights reach them through
    # a file, written once its JAX setup has them
    canon_dir = tmp_path_factory.mktemp("canon")

    def jax_case(name):
        """The JAX setup (its initial weights to ``canon`` and its file),
        then its steps; in a thread: the compiles of the cases overlap."""
        text, plan, _, labels, tables = cases[name][:5]
        try:
            setup, canon0 = _jax_setup(text, plan, tables)
        except BaseException as e:
            canon[name].set_exception(e)
            raise
        canon[name].set_result(canon0)
        R.write_arrays(str(canon_dir / f"{name}.npz"), canon0)
        return _jax_run(setup, batches[name][0], labels, tables,
                        batches[name][1], dumps.get(name, {}).get("jax"))

    with ThreadPoolExecutor(len(own)) as pool:
        jax_refs = {name: pool.submit(jax_case, name) for name in own}
        rank_cases = {}
        for name, (text, plan, _, labels, _, neg, _, _, dump) in \
                cases.items():
            steps_cols, eval_cols = batches[name]
            rank_cases[name] = (
                text, str(canon_dir / f"{SHARED_REF.get(name, name)}.npz"),
                list(zip(*[_halves(c, neg, N_NEG) for c in steps_cols])),
                labels, plan,
                None if eval_cols is None
                else _halves(eval_cols, neg, N_NEG),
                dumps[name]["port"] if dump else None)
        job = dist_util.start_ranks(
            R.global_reductions_rank, WORLD, (rank_cases, helpers,
                                              loop_cfgs[0]),
            store_dir=str(tmp_path_factory.mktemp("store")),
            device="cpu", timeout_s=240)
        # the port's one-rank runs meanwhile
        ones = {name: R.reduction_case(
            None, cases[name][0], canon[name].result(),
            batches[name][0], cases[name][3], cases[name][1],
            batches[name][1], dumps.get(name, {}).get("one"))
            for name in own}
        loop_one = port_main.train_and_evaluate(loop_cfgs[1],
                                                device="cpu")
        refs = {name: (f.result(), ones[name])
                for name, f in jax_refs.items()}
    out = job.wait()
    train = {name: (*refs[SHARED_REF.get(name, name)],
                    [o[0][name] for o in out]) for name in cases}
    return (train, cases, dumps, (helpers, [o[1] for o in out]),
            (loop_cfgs, [o[2] for o in out], loop_one))


TRAIN = ["deepfm_jrc", "dbmtl_jrc", "mind", "hstu_match", "sid_sinkhorn",
         "sid_contrastive", "sid_rqkmeans"]


def _assert_state(got, ref, tol, what):
    sd, opt, losses = got[:3]
    rsd, ropt, rlosses = ref[:3]
    assert set(sd) == set(rsd), what
    for k, v in rsd.items():
        assert_close_to_max(sd[k], v, f"{what} {k}", tol)
    for n, st in ropt.items():
        for k, v in st.items():
            assert_close_to_max(np.asarray(opt[n][k]).reshape(v.shape), v,
                                f"{what} {n}.{k}", tol)
    np.testing.assert_allclose(losses, rlosses, rtol=tol * 10,
                               err_msg=what)


# MIND's steps against the JAX package's: the retrieval tests' step
# tolerance (tests/test_torch_port_match.py; the port's one-rank steps are
# as far from the JAX ones as its two-rank steps)
MATCH_TOL = 1e-4


def _jax_tol(case, runs):
    return MATCH_TOL if case == "mind" else runs[1][case][6]


@pytest.mark.parametrize("case", TRAIN)
def test_world_2_matches_jax_mesh(case, runs):
    jax_ref, _, ranks = runs[0][case]
    _assert_state(ranks[0], jax_ref, _jax_tol(case, runs),
                  f"{case} world 2 vs JAX")
    for sd in (r[0] for r in ranks[1:]):
        for k, v in ranks[0][0].items():
            np.testing.assert_array_equal(sd[k], v, err_msg=k)


@pytest.mark.parametrize("case", TRAIN)
def test_world_2_matches_port_world_1(case, runs):
    jax_ref, one, ranks = runs[0][case]
    _assert_state(one, jax_ref, _jax_tol(case, runs), f"{case} world 1 vs JAX")
    _assert_state(ranks[0], one, runs[1][case][6],
                  f"{case} world 2 vs world 1")


@pytest.mark.parametrize("case", ["deepfm_jrc", "mind"])
def test_eval_metrics_at_world_2_match_jax(case, runs):
    jax_ref, one, ranks = runs[0][case]
    want = jax_ref[3]
    assert want and set(want) == set(ranks[0][3]) == set(one[3])
    for r in ranks:
        for k, v in want.items():
            assert abs(r[3][k] - v) <= 1e-6, (k, r[3][k], v)
            assert abs(one[3][k] - v) <= 1e-6, (k, one[3][k], v)


def _read_dump(d):
    out = {}
    for path in sorted(glob.glob(os.path.join(d, "*.parquet"))):
        t = pq.read_table(path)
        out[os.path.basename(path)] = (
            t.column("id").to_numpy(),
            np.asarray(t.column("embedding").to_pylist(), np.float32))
    return out


def _assert_dump_steps(files):
    steps = {}
    for name in files:
        steps.setdefault(name.rsplit("-", 1)[1], []).append(name)
    assert sorted(steps) == ["2.parquet", "3.parquet"], sorted(files)
    assert all(len(v) == len(BUCKETS)
               for v in steps.values()), sorted(files)


def _assert_same_dump(got, ref, what, merged):
    """The port's shards equal the JAX dumper's. Both engines merge each
    feature's WIDE and DEEP tables (``merged``: the port's map of them);
    the JAX dumper names such a shard after the merged table and writes
    its whole rows, the port names it after the table and writes the
    table's columns."""
    pairs = {}
    for name in got:
        prefix, table, step = name.split("-")
        m = merged.get(table)
        jname = "-".join((prefix, m[0], step)) if m else name
        pairs[name] = (jname, m) if jname in ref else (name, None)
    assert sorted(j for j, _ in pairs.values()) == sorted(ref), what
    for name, (jname, m) in pairs.items():
        ids, rows = ref[jname]
        if m is not None:
            rows = rows[:, m[1]:m[1] + m[2]]
        np.testing.assert_array_equal(got[name][0], ids, err_msg=name)
        assert_close_to_max(got[name][1], rows, f"{what} {name}", TOL)


@pytest.mark.parametrize("case", ["deepfm_jrc", "dump_table_wise"])
def test_delta_dump_at_world_2_writes_the_jax_files(case, runs):
    """Under ``row_wise`` (the JRC DeepFM) and ``table_wise``."""
    dirs = runs[2][case]
    ref = _read_dump(dirs["jax"])
    # files at both dump steps, a table a feature (the dumper keys its
    # ids by feature: a feature's last lookup names the table)
    _assert_dump_steps(ref)
    merged = port_main._build_model_and_optim(
        parse_pipeline_config(runs[1][case][0]), "cpu")[0] \
        .embedding_group.engine._merged
    got = _read_dump(os.path.join(dirs["port"], "rank_0"))
    _assert_dump_steps(got)
    _assert_same_dump(got, ref, "world 2", merged)
    assert not _read_dump(os.path.join(dirs["port"], "rank_1"))
    _assert_same_dump(_read_dump(dirs["one"]), ref, "world 1", merged)
    jax_ref, _, ranks = runs[0][case]
    _assert_state(ranks[0], jax_ref, TOL, case)


def test_train_and_evaluate_dump_at_world_2_equals_world_1(runs):
    cfgs, ranks, one = runs[4]
    assert [int(r["step"]) for r in ranks] == [LOOP_STEPS] * WORLD
    assert int(one["step"]) == LOOP_STEPS
    dirs = [os.path.join(os.path.dirname(p), name, "delta_embedding_dump")
            for p, name in zip(cfgs, ("world_2", "world_1"))]
    got, ref = _read_dump(dirs[0]), _read_dump(dirs[1])
    _assert_dump_steps(ref)
    # both the port's: the same table names
    _assert_same_dump(got, ref, "train_and_evaluate world 2", {})


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("helper", ["logsumexp_rows", "gather_host_steps"])
def test_mesh_helpers_match_their_formula(helper, world, runs):
    (x, parts), ranks = runs[3]
    lse, grad, steps = _helper_refs(x, parts, world)
    if world == 1:
        xt = torch.from_numpy(x).requires_grad_(True)
        got_lse = mesh.logsumexp_rows(xt, None)
        w = torch.arange(1, x.shape[1] + 1, dtype=torch.float32)
        (got_lse * w).sum().backward()
        got = [(got_lse.detach().numpy(), xt.grad.numpy(),
                mesh.gather_host_steps(parts[0], None))]
        steps = np.concatenate(parts[0])
        per = x.shape[0]
    else:
        got = ranks
        per = x.shape[0] // WORLD
    for r, (g_lse, g_grad, g_steps) in enumerate(got):
        if helper == "logsumexp_rows":
            np.testing.assert_allclose(g_lse, lse, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g_grad, grad[r * per:(r + 1) * per],
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g_steps, steps)

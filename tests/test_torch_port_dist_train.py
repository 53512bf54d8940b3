"""Training over two ranks of the port against the JAX package, on the
CPU (gloo, ranks spawned with a ``FileStore`` under ``tmp_path``, each
spawn with its own time limit; a rank that raises brings the spawn
down).

Train steps (one spawn): the port's ``make_train_step`` at world size 2,
each rank on its half of every global batch, against the JAX
``make_train_step`` on the whole batch: on a 2-device mesh with the same
plan for DeepFM (every layout among its tables: the gradient scale),
DeepFM with sample weights and MLP batch norm (the weighted loss's
global divisor, the global batch statistics and running statistics) and
MultiTowerDIN with a sequence feature; on one device (the same global
semantics) for DSSM with in-batch negatives (the items gathered with
their gradients, each user labelled with its global row) and hstu_synth's
DLRM-HSTU (candidate counts that differ per rank: the loss's global
divisor). Dense parameters, tables and sparse row state within 1e-5 of
each tensor's max after 3 steps (DLRM-HSTU: 1e-4, as its single-rank
tests); every rank's state_dict equal to rank 0's.

``_sim`` with sampled and hard negatives, no processes: the JAX ``_sim``
with ``jax.process_count`` patched to 2 on the two ranks' blocks
concatenated equals the port's per-rank results concatenated.

Entry points (one spawn): ``train_and_evaluate`` of a small DeepFM at
world size 2 from uneven parquet files (each rank its own files) stops
both ranks on the same step, the one the shorter shard allows, and
writes ``sharding_plan.json``; ``evaluate`` at world size 2 gives the
AUC of a world-1 ``evaluate`` of the same checkpoint (to 1e-6); a
``continue_train`` at world size 2 reuses the saved plan; the world-2
checkpoint restores at world size 1 bit for bit.

Builds (one spawn): RQ-VAE builds at world size 2 without raising. The
models whose reductions span the global batch are held at world size 2
in tests/test_torch_port_global_reductions.py.
"""

import json
import os
import sys
import types
from pathlib import Path
from unittest import mock

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
from torcheasyrec_tpu.models.match_model import MatchModel as JaxMatchModel
from torcheasyrec_tpu.optim.optimizer_builder import create_dense_optimizer
from torcheasyrec_tpu.parallel.mesh import create_mesh
from torcheasyrec_tpu.protos import pipeline_pb2
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.models.match_model import MatchModel
from torcheasyrec_tpu_torch.utils import checkpoint_util, dist_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_dist_ranks as R  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_close_to_max,
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    hstu_synth_train_config_text,
    synth_cols,
)

TOL = 1e-5
HSTU_TOL = 1e-4
GLOBAL_B = 32
ADAM = "adam_optimizer { lr: 0.01 eps: 1e-4 } constant_learning_rate {}"
LAYOUTS = ["row_wise", "column_wise", "table_wise", "table_row_wise",
           "data_parallel", "row_wise"]


def _mixed_plan():
    names = deepfm_table_names()
    return {n: LAYOUTS[i % len(LAYOUTS)] for i, n in enumerate(names)}


def _deepfm(**kw):
    return deepfm_config_text(batch_size=GLOBAL_B, dense_opt=ADAM, **kw)


def _weighted_bn_text():
    text = _deepfm()
    text = text.replace('  label_fields: "label"',
                        '  label_fields: "label"\n'
                        '  sample_weight_fields: "w"')
    return text.replace("deep { hidden_units: [32, 16] }",
                        "deep { hidden_units: [32, 16] use_bn: true }")


def _weighted_cols(n, seed):
    cols = deepfm_cols(n, seed)
    cols["w"] = pa.array(np.random.default_rng(seed + 7).uniform(
        0.2, 2.0, n).astype(np.float32))
    return cols


DIN_TEXT = """
train_config {
  sparse_optimizer { adagrad_optimizer { lr: 0.05 } constant_learning_rate {} }
  dense_optimizer { adam_optimizer { lr: 0.01 eps: 1e-4 } constant_learning_rate {} }
  num_epochs: 1
}
data_config { batch_size: 32 dataset_type: ParquetDataset fg_mode: FG_NONE
              label_fields: "label" }
feature_configs { id_feature { feature_name: 'uid' num_buckets: 500 embedding_dim: 16 } }
feature_configs { id_feature { feature_name: 'iid' num_buckets: 2000 embedding_dim: 16 } }
feature_configs { raw_feature { feature_name: 'price' } }
feature_configs { sequence_id_feature { feature_name: 'clicks' num_buckets: 2000
  embedding_dim: 16 sequence_length: 8 embedding_name: 'iid_emb' } }
model_config {
  feature_groups { group_name: "all" feature_names: ["uid", "iid", "price"]
                   group_type: DEEP }
  feature_groups { group_name: "seq" feature_names: ["iid", "clicks"]
                   group_type: SEQUENCE }
  multi_tower_din {
    towers { input: "all" mlp { hidden_units: [16] } }
    din_towers { input: "seq" attn_mlp { hidden_units: [8] } }
    final { hidden_units: [16] } }
  losses { binary_cross_entropy {} }
  metrics { auc {} }
}
"""


def _din_cols(n, seed):
    r = np.random.default_rng(seed)
    return {
        "uid": pa.array(r.integers(0, 500, n)),
        "iid": pa.array(r.integers(0, 2000, n)),
        "price": pa.array(r.normal(size=n).astype(np.float32)),
        "clicks": pa.array([";".join(map(str, r.integers(
            0, 2000, int(r.integers(1, 8))))) for _ in range(n)]),
        "label": pa.array((r.random(n) > 0.5).astype(np.float32)),
    }


DSSM_TEXT = """
train_config {
  sparse_optimizer { adagrad_optimizer { lr: 0.05 eps: 1e-4 } constant_learning_rate {} }
  dense_optimizer { adam_optimizer { lr: 0.001 eps: 1e-4 } constant_learning_rate {} }
  num_epochs: 1
}
data_config { batch_size: 32 dataset_type: ParquetDataset fg_mode: FG_NONE
              label_fields: "label" }
feature_configs { id_feature { feature_name: "user" num_buckets: 300 embedding_dim: 8 } }
feature_configs { raw_feature { feature_name: "int_0" } }
feature_configs { id_feature { feature_name: "item" num_buckets: 400 embedding_dim: 8 } }
model_config {
  feature_groups { group_name: "user" feature_names: ["user", "int_0"] group_type: DEEP }
  feature_groups { group_name: "item" feature_names: ["item"] group_type: DEEP }
  dssm { user_tower { input: "user" mlp { hidden_units: [16, 8] } }
         item_tower { input: "item" mlp { hidden_units: [16, 8] } }
         output_dim: 8 temperature: 0.2 in_batch_negative: true }
  losses { softmax_cross_entropy {} }
  metrics { recall_at_k { top_k: 1 } }
}
"""


def _dssm_cols(n, seed):
    r = np.random.default_rng(seed)
    user = r.integers(0, 300, n)
    return {"user": pa.array(user),
            "int_0": pa.array(r.normal(size=n).astype(np.float32)),
            "item": pa.array((user + r.integers(0, 5, n)) % 400),
            "label": pa.array(np.ones(n, np.float32))}


def _hstu_cols(n, seed):
    cols = synth_cols(n, seed)
    return cols


# name -> (config text, plan or None, columns fn, labels, mesh, tol)
TRAIN_CASES = {
    "deepfm_layouts": (_deepfm(), _mixed_plan(), deepfm_cols, ["label"],
                       True, TOL),
    "deepfm_weighted_bn": (_weighted_bn_text(), None, _weighted_cols,
                           ["label"], True, TOL),
    "din_sequence": (DIN_TEXT, {"iid_emb": "row_wise",
                                "uid_emb": "column_wise"}, _din_cols,
                     ["label"], True, TOL),
    "dssm_in_batch": (DSSM_TEXT, None, _dssm_cols, ["label"], False, TOL),
    "dlrm_hstu": (hstu_synth_train_config_text(batch_size=8, num_layers=1),
                  None, _hstu_cols, [], False, HSTU_TOL),
}


def _jax_init(text, plan, on_mesh, table_names):
    """The JAX package's model and train state, and its initial weights
    as a state_dict for the port."""
    cfg = text_format.Parse(text, pipeline_pb2.EasyRecConfig())
    mesh = create_mesh(jax.devices()[:2]) if on_mesh else None
    model, features, sparse_sched = jax_main._build_model_and_optim(
        cfg, mesh, plan=plan)
    dense, tables, sparse_opt = jax_main._init_state(model, cfg)
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, dense)
    state = {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
             "dense_opt": tx.init(dense), "step": jnp.zeros((), jnp.int32)}
    canon0 = {k: v.numpy() for k, v in converted_state(
        model, dense, tables, table_names).items()}
    return (model, features, sparse_sched, tx, dense_sched, state, mesh), \
        canon0


def _jax_steps(setup, steps_cols, labels, table_names):
    """(final state_dict, sparse state per table, losses) of the JAX
    package's steps over the global batches."""
    model, features, sparse_sched, tx, dense_sched, state, mesh = setup
    step = jax.jit(jax_main.make_train_step(
        model, tx, sparse_sched, dense_sched, jnp.float32))
    parser = JaxParser(features, labels=labels)
    losses = []
    for cols in steps_cols:
        batch = parser.parse_to_batch(cols)
        if mesh is not None:
            batch = jax_main._shard_batch(batch, mesh)
        state, metrics, updates = step(state, batch, jax.random.key(0))
        if updates:
            state["dense"] = jax_main.apply_state_updates(
                state["dense"], jax.device_get(updates))
        losses.append(float(metrics["total_loss"]))
    final = {k: v.numpy() for k, v in converted_state(
        model, state["dense"], state["tables"], table_names).items()}
    eng = model.embedding_group.engine
    opt = {n: {k: np.asarray(v) for k, v in eng.extract_table_state(
        state["tables"], state["sparse_opt"], n).items()}
        for n in table_names}
    return final, opt, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks for the whole file: the train steps of
    every case, the entry points and the builds. The JAX steps run
    while the ranks do. Returns ({case: (JAX result, [rank results])},
    (config path, model dir, [entry results]), [builds])."""
    cfg_path, model_dir = _entry_files(tmp_path_factory.mktemp("entry"))
    texts = _built_texts()
    os.environ["TZREC_TABLE_MERGE"] = "0"
    try:
        setups, rank_cases = {}, []
        for name, (text, plan, cols_fn, labels, on_mesh, _) in \
                TRAIN_CASES.items():
            names = list(port_main._build_model_and_optim(
                parse_pipeline_config(text), "cpu")[0]
                .embedding_group.engine._specs)
            n = 8 if name == "dlrm_hstu" else GLOBAL_B
            steps_cols = [cols_fn(n, 10 + i) for i in range(3)]
            setup, canon0 = _jax_init(text, plan, on_mesh, names)
            setups[name] = (setup, steps_cols, labels, names)
            rank_cases.append((text, canon0, steps_cols, labels, plan))
        job = dist_util.start_ranks(
            R.whole_file_rank, 2, (rank_cases, cfg_path, 2, texts),
            store_dir=str(tmp_path_factory.mktemp("store")), device="cpu",
            timeout_s=240)
        refs = {name: _jax_steps(*args) for name, args in setups.items()}
    finally:
        os.environ.pop("TZREC_TABLE_MERGE", None)
    out = job.wait()
    train = {name: (refs[name], [o[0][i] for o in out])
             for i, name in enumerate(TRAIN_CASES)}
    return train, (cfg_path, model_dir, [o[1] for o in out]), \
        [o[2] for o in out]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_steps_at_world_2_match_jax(case, runs):
    (final, opt, losses), ranks = runs[0][case]
    tol = TRAIN_CASES[case][5]
    sd0, opt0, losses0 = ranks[0]
    assert set(sd0) == set(final)
    for k, v in final.items():
        assert_close_to_max(sd0[k], v, k, tol)
        for sd, _, _ in ranks[1:]:
            np.testing.assert_array_equal(sd[k], sd0[k], err_msg=k)
    for n, st in opt.items():
        for k, v in st.items():
            assert_close_to_max(np.asarray(opt0[n][k]).reshape(v.shape), v,
                                f"{n}.{k}", tol)
    np.testing.assert_allclose(losses0, losses, rtol=tol * 10)


def _sim_blocks(p=2, bl=3, s=4, k=2, d=5, seed=5):
    """Per-rank (user, items [bl pos | s neg | bl*k hard], hard indices)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(p):
        idx = np.full((bl * k, 2), [bl, 0], np.int32)
        for i in range(bl):
            for j in range(int(r.integers(0, k + 1))):
                idx[i * k + j] = (i, j)
        out.append((r.normal(size=(bl, d)).astype(np.float32),
                    r.normal(size=(bl + s + bl * k, d)).astype(np.float32),
                    idx))
    return out


@pytest.mark.parametrize("hard", [False, True])
def test_sim_blocks_match_jax_processes(hard):
    blocks = _sim_blocks(k=2 if hard else 0)
    user = np.concatenate([u for u, _, _ in blocks])
    items = np.concatenate([it for _, it, _ in blocks])
    idx = np.concatenate([i for _, _, i in blocks]) if hard else None
    with mock.patch.object(jax, "process_count", lambda: 2):
        ref = np.asarray(JaxMatchModel._sim(
            types.SimpleNamespace(_in_batch_negative=False),
            jnp.asarray(user), jnp.asarray(items),
            None if idx is None else jnp.asarray(idx)))
    got = np.concatenate([MatchModel._sim(
        types.SimpleNamespace(_in_batch_negative=False),
        torch.from_numpy(u), torch.from_numpy(it),
        torch.from_numpy(i) if hard else None).numpy()
        for u, it, i in blocks])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# --- the entry points ----------------------------------------------------------

ENTRY_B = 32  # a rank's batch
TRAIN_ROWS = (300, 200, 250)  # file i goes to rank i % 2: 550 and 200 rows
EVAL_ROWS = (150, 90)


def _entry_files(root):
    """(config path, model dir) of the entry-point run: uneven train and
    eval files, each rank its own."""
    train, evals = [], []
    for i, n in enumerate(TRAIN_ROWS):
        path = str(root / f"train_{i}.parquet")
        pq.write_table(pa.table(deepfm_cols(n, 40 + i)), path)
        train.append(path)
    for i, n in enumerate(EVAL_ROWS):
        path = str(root / f"eval_{i}.parquet")
        pq.write_table(pa.table(deepfm_cols(n, 60 + i)), path)
        evals.append(path)
    model_dir = str(root / "model")
    # row-sharded and column-sharded tables: the planner picks
    text = deepfm_config_text(
        batch_size=ENTRY_B, model_dir=model_dir, dense_opt=ADAM,
        feature_extra='embedding_constraints { sharding_types: "row_wise" '
                      'sharding_types: "column_wise" } ')
    text = text.replace('train_input_path: "unused"',
                        f'train_input_path: "{",".join(train)}"')
    text = text.replace('eval_input_path: "unused"',
                        f'eval_input_path: "{",".join(evals)}"')
    text = text.replace('  label_fields: "label"',
                        '  label_fields: "label"\n  eval_batch_size: 32')
    cfg_path = str(root / "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    return cfg_path, model_dir


@pytest.fixture(scope="module")
def entry_run(runs):
    return runs[1]


def test_train_and_evaluate_ranks_stop_together(entry_run):
    _, model_dir, out = entry_run
    steps = [int(first["step"]) for first, _, _ in out]
    # the shorter shard (200 rows) allows 6 batches of 32
    assert steps == [TRAIN_ROWS[1] // ENTRY_B] * 2
    assert checkpoint_util.latest_checkpoint(model_dir).endswith(
        f"model.ckpt-{steps[0] + 2}.pt")
    with open(os.path.join(model_dir, "sharding_plan.json")) as f:
        plan = json.load(f)
    assert set(plan) == set(deepfm_table_names())
    assert set(plan.values()) <= {"row_wise", "column_wise"}
    assert [int(again["step"]) for _, _, again in out] == [steps[0] + 2] * 2


def test_gathered_auc_equals_one_rank(entry_run):
    cfg_path, model_dir, out = entry_run
    step = int(out[0][0]["step"])
    ev = [e for _, e, _ in out]
    assert ev[0]["auc"] == ev[1]["auc"]
    one = port_main.evaluate(
        cfg_path, checkpoint_path=checkpoint_util.checkpoint_path(
            model_dir, step), device="cpu")
    assert abs(one["auc"] - ev[0]["auc"]) <= 1e-6
    # the train-time eval of that checkpoint saw the same rows
    assert abs(out[0][0]["auc"] - one["auc"]) <= 1e-6


def test_world_2_checkpoint_restores_at_world_1(entry_run):
    cfg_path, model_dir, _ = entry_run
    path = checkpoint_util.latest_checkpoint(model_dir)
    cfg = parse_pipeline_config(open(cfg_path).read())
    model, _, _ = port_main._build_model_and_optim(cfg, "cpu")
    tx, _ = port_main._dense_optimizer(model, cfg.train_config)
    restored = checkpoint_util.restore_checkpoint(path, model, tx)
    ckpt = torch.load(path, weights_only=True)
    sd = model.state_dict()
    for k, v in ckpt["model"].items():
        assert torch.equal(sd[k], v), k
    opt = model.embedding_group.opt_state_dict(restored["sparse_opt"])
    for n, st in ckpt["sparse_opt"].items():
        for k, v in st.items():
            assert torch.equal(opt[n][k].reshape(v.shape), v), (n, k)


# --- builds ---------------------------------------------------------------


def _built_texts():
    from test_torch_port_sid import RQVAE, sid_config_text

    return {"sid_rqvae": sid_config_text(RQVAE)}


@pytest.fixture(scope="module")
def builds(runs):
    return runs[2]


def test_rqvae_builds_at_world_2(builds):
    """RQ-VAE without Sinkhorn or the contrastive loss reduces over the
    batch only in its losses' means, which span the ranks: it builds."""
    for out in builds:
        assert out["sid_rqvae"] is None

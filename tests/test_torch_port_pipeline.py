"""The training loop's two overlaps in the port, on the CPU, and the eval
over ranks when a rank has no rows.

Over two gloo ranks (one spawn for the file, the JAX references computed
while the ranks run):

- the engine: ``lookup(staged=stage_route(batch))`` gives the inline
  lookup's outputs, tables and row state bit for bit over three steps,
  for a packed and an unpacked ``row_wise`` engine, every row-sharded
  group staged; an EmbeddingGroup's ZCH group is not staged, its plain
  group is;
- the train step through ``train_epoch`` with ``pipelined`` equals the
  unpipelined one bit for bit, and the JAX package's steps on a
  2-device mesh within the tolerance of
  test_torch_port_dist_train.py (DeepFM over every layout);
- ``train_and_evaluate`` with ``sparse_dist_overlap`` equals the
  unpipelined run bit for bit (results, eval lines, every checkpoint:
  weights, sparse and dense optimizer state, watermark) over two
  epochs with gradient accumulation, straight and resumed mid-epoch;
- F11: the eval over ranks stops where the JAX package's loop stops
  (``mh.sync_batch_dims``'s break rule, its gathers stubbed over two
  threads), and a rank without rows gives the JAX package's metric value
  over no rows (AUC NaN) instead of raising.

On one rank: the host-row prefetcher of a host-offloaded DeepFM over a
60-id vocabulary (every batch collides with the one before) gives the
run without it bit for bit, and it is the repair that makes it so
(without it the tables differ); both equal the JAX package's run with
its prefetcher, at test_torch_port_host_offload.py's tolerance."""

import json
import os
import sys
import threading
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.utils import checkpoint_util, dist_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_dist_ranks as R  # noqa: E402
from test_torch_port_dist_engine import _steps as engine_steps  # noqa: E402
from test_torch_port_dist_train import (  # noqa: E402
    TOL,
    TRAIN_CASES,
    _jax_init,
    _jax_steps,
)
from torch_port_helpers import (  # noqa: E402
    assert_close_to_max,
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    jax_model_and_state,
)

RANK_B = 32  # a rank's batch in the loop runs
TRAIN_ROWS = (300, 200, 250)  # file i goes to rank i % 2: 17 and 6 batches
EVAL_ROWS = (150, 90)
RESUME_AT = 3  # mid-way through the first epoch of 6 steps
ADAM = "adam_optimizer { lr: 0.01 eps: 1e-4 } constant_learning_rate {}"


def _loop_configs(root):
    """{name: config path}: the same DeepFM (every table ``row_wise``,
    two epochs, gradient accumulation over 2, a save and an eval every 4
    steps), with and without ``sparse_dist_overlap``, each resumed or
    not, each in its own model dir."""
    train, evals = [], []
    for i, n in enumerate(TRAIN_ROWS):
        path = str(root / f"train_{i}.parquet")
        pq.write_table(pa.table(deepfm_cols(n, 70 + i)), path)
        train.append(path)
    for i, n in enumerate(EVAL_ROWS):
        path = str(root / f"eval_{i}.parquet")
        pq.write_table(pa.table(deepfm_cols(n, 80 + i)), path)
        evals.append(path)
    out = {}
    for name in ("plain", "overlap", "plain_resumed", "overlap_resumed"):
        extra = ("  gradient_accumulation_steps: 2\n"
                 "  save_checkpoints_steps: 4\n"
                 "  use_tensorboard: false\n")
        if name.startswith("overlap"):
            extra += "  sparse_dist_overlap: true\n"
        text = deepfm_config_text(
            batch_size=RANK_B, model_dir=str(root / name), dense_opt=ADAM,
            train_extra=extra,
            feature_extra='embedding_constraints { sharding_types: '
                          '"row_wise" } ')
        text = text.replace("  num_epochs: 1", "  num_epochs: 2")
        text = text.replace('train_input_path: "unused"',
                            f'train_input_path: "{",".join(train)}"')
        text = text.replace('eval_input_path: "unused"',
                            f'eval_input_path: "{",".join(evals)}"')
        text = text.replace('  label_fields: "label"',
                            '  label_fields: "label"\n  eval_batch_size: 32')
        path = str(root / f"{name}.config")
        with open(path, "w") as f:
            f.write(text)
        out[name] = path
    return out


def _decision_feeds():
    """Per case, each rank's eval batches ({"p", "y"}): a rank with none,
    a rank with fewer, both alike."""
    r = np.random.default_rng(9)

    def batch():
        return {"p": r.random(8).astype(np.float32),
                "y": (r.random(8) > 0.5).astype(np.float32)}

    return [[[batch() for _ in range(3)], []],
            [[batch() for _ in range(3)], [batch()]],
            [[batch(), batch()], [batch(), batch()]]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks: (engine cases, ZCH case, train-step runs,
    loop runs, eval decisions), with the JAX steps of the train case and
    the inputs the parent compares with."""
    r = np.random.default_rng(3)
    canon = {n: (r.random((rows, d), np.float32) - 0.5)
             for n, rows, d in R.ENGINE_TABLES}
    steps = engine_steps()
    text, plan, cols_fn, labels, _, _ = TRAIN_CASES["deepfm_layouts"]
    names = list(port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu")[0].embedding_group.engine._specs)
    steps_cols = [cols_fn(32, 10 + i) for i in range(3)]
    loop = _loop_configs(tmp_path_factory.mktemp("loop"))
    decisions = _decision_feeds()
    # the ranks start first; the JAX model's initial weights reach their
    # train case through a file, written once the JAX setup has them
    canon_path = str(tmp_path_factory.mktemp("canon") / "canon0.npz")
    job = dist_util.start_ranks(
        R.pipeline_file_rank, 2,
        ((canon, steps), (text, canon_path, steps_cols, labels, plan),
         (loop, RESUME_AT), decisions),
        store_dir=str(tmp_path_factory.mktemp("store")), device="cpu",
        timeout_s=300)
    setup, canon0 = _jax_init(text, plan, True, names)
    R.write_arrays(canon_path, canon0)
    ref = _jax_steps(setup, steps_cols, labels, names)
    return job.wait(), ref, loop, decisions


# --- the staged route ---------------------------------------------------------


def _assert_same_engine_run(a, b):
    outs_a, w_a, st_a = a
    outs_b, w_b, st_b = b
    for i, (oa, ob) in enumerate(zip(outs_a, outs_b)):
        assert oa.keys() == ob.keys()
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k], err_msg=f"{i} {k}")
    for n in w_a:
        np.testing.assert_array_equal(w_a[n], w_b[n], err_msg=n)
        for k in st_a[n]:
            np.testing.assert_array_equal(st_a[n][k], st_b[n][k],
                                          err_msg=f"{n}.{k}")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_staged_lookup_equals_inline(runs, packed):
    for rank in runs[0]:
        inline, staged, staged_groups, groups, inline_routes = \
            rank[0][0 if packed else 1]
        routed = sorted(gk for gk, (sh, _) in groups.items()
                        if sh == "row_wise")
        assert routed and {p for _, p in groups.values()} == {packed}
        # every step but the last staged every row-sharded group, and only
        # the first step's lookup routed its own ids
        assert staged_groups == [routed, routed]
        assert inline_routes == len(routed)
        _assert_same_engine_run(staged, inline)


def test_zch_group_is_not_staged(runs):
    for rank in runs[0]:
        staged, tables, out_s, out_i = rank[1]
        assert tables["z_emb"] != tables["p_emb"]
        assert staged == [tables["p_emb"]]
        assert out_s.keys() == out_i.keys()
        for k in out_s:
            np.testing.assert_array_equal(out_s[k], out_i[k], err_msg=k)


# --- the train step and the loop ----------------------------------------------


def test_pipelined_steps_equal_unpipelined_and_match_jax(runs):
    (final, opt, losses), ranks = runs[1], runs[0]
    for rank in ranks:
        (sd_u, opt_u, loss_u, staged_u), (sd_p, opt_p, loss_p, staged_p) = \
            rank[2]
        assert staged_u == [] and staged_p == [True, True]
        assert loss_p == loss_u
        for k in sd_u:
            np.testing.assert_array_equal(sd_p[k], sd_u[k], err_msg=k)
        for n in opt_u:
            for k in opt_u[n]:
                np.testing.assert_array_equal(opt_p[n][k], opt_u[n][k])
    sd0, opt0, losses0, _ = ranks[0][2][1]
    assert set(sd0) == set(final)
    for k, v in final.items():
        assert_close_to_max(sd0[k], v, k, TOL)
        np.testing.assert_array_equal(ranks[1][2][1][0][k], sd0[k])
    for n, st in opt.items():
        for k, v in st.items():
            assert_close_to_max(np.asarray(opt0[n][k]).reshape(v.shape), v,
                                f"{n}.{k}", TOL)
    np.testing.assert_allclose(losses0, losses, rtol=TOL * 10)


def _eval_lines(model_dir):
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        return [json.loads(line) for line in f]


def _ckpt(model_dir, step):
    return torch.load(checkpoint_util.checkpoint_path(model_dir, step),
                      weights_only=True)


def _assert_same_checkpoint(a, b):
    assert (a["step"], a["epoch"], a["dataloader_state"]) == (
        b["step"], b["epoch"], b["dataloader_state"])
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for t in a["sparse_opt"]:
        for k in a["sparse_opt"][t]:
            assert torch.equal(a["sparse_opt"][t][k], b["sparse_opt"][t][k])
    assert a["dense_opt"]["count"] == b["dense_opt"]["count"]
    for st_a, st_b in zip(a["dense_opt"]["state"], b["dense_opt"]["state"]):
        for k in st_a:
            assert torch.equal(st_a[k], st_b[k]), k
    assert len(a["accum_grads"]) == len(b["accum_grads"])
    for i, (g_a, g_b) in enumerate(zip(a["accum_grads"], b["accum_grads"])):
        assert torch.equal(g_a, g_b), i


def _model_dir(loop, name):
    return loop[name][:-len(".config")]


def test_overlap_loop_equals_unpipelined(runs):
    (ranks, _, loop, _) = runs
    steps_an_epoch = TRAIN_ROWS[1] // RANK_B
    for rank in ranks:
        results, stages = rank[3]
        assert results["overlap"] == results["plain"]
        assert results["overlap"]["step"] == 2 * steps_an_epoch
        assert stages["plain"] == []
        # every step stages the next batch's route but each epoch's last
        assert stages["overlap"] == [True] * (2 * (steps_an_epoch - 1))
    plain, overlap = _model_dir(loop, "plain"), _model_dir(loop, "overlap")
    assert _eval_lines(overlap) == _eval_lines(plain)
    saved = sorted(checkpoint_util.list_checkpoints(plain))
    assert saved == sorted(checkpoint_util.list_checkpoints(overlap)) == [
        4, 8, 12]
    for step in saved:
        _assert_same_checkpoint(_ckpt(overlap, step), _ckpt(plain, step))


def test_overlap_loop_resumed_mid_epoch_equals_unpipelined(runs):
    (ranks, _, loop, _) = runs
    for rank in ranks:
        results, stages = rank[3]
        (first_o, again_o), (first_p, again_p) = (
            results["overlap_resumed"], results["plain_resumed"])
        assert first_o == first_p and first_o["step"] == RESUME_AT
        assert again_o == again_p and again_o["step"] == 12
    a = _model_dir(loop, "overlap_resumed")
    b = _model_dir(loop, "plain_resumed")
    mid = _ckpt(a, RESUME_AT)
    assert mid["epoch"] == 0 and "staged" not in mid
    assert _eval_lines(a) == _eval_lines(b)
    for step in (RESUME_AT, 4, 8, 12):
        _assert_same_checkpoint(_ckpt(a, step), _ckpt(b, step))


# --- F11: the eval over ranks, a rank without rows ------------------------------


class _TwoHosts:
    """``multihost_utils.process_allgather`` for two threads, each one
    host: every call blocks until both have called, then returns both
    values stacked in host order."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=60)
        self.slots = [None, None]
        self.host = threading.local()

    def gather(self, x):
        i = self.host.index
        self.slots[i] = np.asarray(x)
        self.barrier.wait()
        out = np.stack(self.slots)
        self.barrier.wait()
        return out


def _jax_decision(per_host):
    """Steps of the JAX package's ``_run_eval_multiprocess_loop`` on each
    of two hosts fed ``per_host``, over stubbed gathers (the global batch
    is the host's own; the eval step counts)."""
    from jax.experimental import multihost_utils

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.utils import multihost as mh

    hosts = _TwoHosts()
    steps = [0, 0]
    errors = []

    class Model:
        def update_metrics(self, metrics, preds, batch):
            metrics.append(len(batch["p"]))

    def run(i):
        hosts.host.index = i

        def eval_step(state, gbatch):
            steps[i] += 1
            return {"p": gbatch["p"]}, {"l": 0.5}

        try:
            jax_main._run_eval_multiprocess_loop(
                Model(), eval_step, None, None, [], {}, 0,
                iter([(b, types.SimpleNamespace(batch_size=len(b["p"])))
                      for b in per_host[i]]), None)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with mock.patch.object(multihost_utils, "process_allgather",
                           hosts.gather), \
            mock.patch.object(mh, "pad_batch_to", lambda b, *a, **k: b), \
            mock.patch.object(mh, "attach_global_segments",
                              lambda b, *a: b), \
            mock.patch.object(mh, "make_global_batch", lambda b, *a: b), \
            mock.patch.object(mh, "local_rows", lambda x, n: x):
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not errors, errors
    return steps


def test_eval_over_ranks_stops_as_jax_and_a_rank_without_rows_does_not_raise(
        runs):
    from torcheasyrec_tpu.metrics import AUC as JaxAUC

    ranks, _, _, decisions = runs
    for case, per_host in enumerate(decisions):
        jax_steps = _jax_decision(per_host)
        assert jax_steps[0] == jax_steps[1]
        port = [rank[4][case] for rank in ranks]
        assert [n for n, _ in port] == jax_steps, (case, port, jax_steps)
        assert port[0][1] == port[1][1] or np.isnan(port[0][1]["auc"])
    # a rank without rows: no step on either package, and the metric of
    # the JAX package over no rows (its ``sync`` leaves an empty array)
    assert _jax_decision(decisions[0]) == [0, 0]
    jauc = JaxAUC()
    jauc.sync()
    assert np.isnan(jauc.compute())
    for rank in ranks:
        n, result = rank[4][0]
        assert n == 0 and set(result) == {"auc"}
        assert np.isnan(result["auc"])
    # rows on both ranks: the AUC of all the rows fed
    feeds = decisions[1]
    rows = [b for b in feeds[0]] + [feeds[1][0]]
    ref = JaxAUC()
    for b in rows:
        ref.update(b["p"], b["y"])
    assert ranks[0][4][1][1]["auc"] == ref.compute()


# --- the host-row prefetcher ----------------------------------------------------

HOST_TEXT = """
train_input_path: "{root}/train.parquet"
eval_input_path: "{root}/eval.parquet"
model_dir: "{root}/{name}"
train_config {{
    sparse_optimizer {{ adagrad_optimizer {{ lr: 0.1 }}
                        constant_learning_rate {{}} }}
    dense_optimizer {{ adam_optimizer {{ lr: 0.01 }}
                       constant_learning_rate {{}} }}
    num_epochs: 3
    save_checkpoints_steps: 10000
    use_tensorboard: false
}}
data_config {{
    batch_size: 128
    dataset_type: ParquetDataset
    fg_mode: FG_NONE
    label_fields: "label"
}}
feature_configs {{
    id_feature {{
        feature_name: "item_id"
        num_buckets: 60
        embedding_dim: 8
        embedding_constraints {{ sharding_types: "host_offload" }}
    }}
}}
model_config {{
    feature_groups {{ group_name: "deep" feature_names: "item_id"
                      group_type: DEEP }}
    feature_groups {{ group_name: "wide" feature_names: "item_id"
                      group_type: WIDE }}
    deepfm {{ deep {{ hidden_units: [16] }} }}
    losses {{ binary_cross_entropy {{}} }}
    metrics {{ auc {{}} }}
}}
"""
HOST_TABLES = ("item_id_emb", "item_id_emb__wide")


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """The data of the JAX package's test_host_prefetch_overlap_exact; the
    JAX run with its prefetcher (one device), then the port's from the
    same weights: prefetch on, off, and on with the repair taken out.
    Returns ({name: (result, checkpoint, eval lines)}, JAX (tables,
    state, dense), prefetched batches and repaired rows of the on run)."""
    import jax.numpy as jnp

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.utils import checkpoint_util as jax_ckpt
    from torcheasyrec_tpu_torch.parallel.emb_engine import EmbeddingEngine

    root = tmp_path_factory.mktemp("host")
    rng = np.random.default_rng(1)
    n = 1024
    ids = rng.integers(0, 60, n)  # tiny vocab: every batch collides
    labels = (rng.random(n) < 0.5).astype(np.float32)
    tbl = pa.table({"item_id": pa.array(ids.astype(np.int64)),
                    "label": pa.array(labels)})
    pq.write_table(tbl.slice(0, 768), str(root / "train.parquet"))
    pq.write_table(tbl.slice(768), str(root / "eval.parquet"))

    def cfg(name):
        path = str(root / f"{name}.config")
        text = HOST_TEXT.format(root=root, name=name)
        with open(path, "w") as f:
            f.write(text)
        return path, text

    jpath, text = cfg("jax")
    with mock.patch.object(jax_main, "maybe_mesh", lambda: None), \
            mock.patch.dict(os.environ, {"TZREC_HOST_PREFETCH": "1"}):
        jax_main.train_and_evaluate(jpath)
    jcfg, jmodel, _, dense, tables = jax_model_and_state(text)
    init = str(root / "init.pt")
    torch.save(converted_state(jmodel, dense, tables, HOST_TABLES), init)
    jmodel, _, _ = jax_main._build_model_and_optim(jcfg, None)
    dense, tables, sparse_opt = jax_main._init_state(jmodel, None)
    state = jax_ckpt.restore_train_state(
        jax_ckpt.latest_checkpoint(str(root / "jax")), jmodel,
        {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
         "step": jnp.zeros((), jnp.int32)})
    eng = jmodel.embedding_group.engine
    jax_ref = (converted_state(jmodel, state["dense"], state["tables"],
                               HOST_TABLES),
               {t: {k: np.asarray(v) for k, v in eng.extract_table_state(
                   state["tables"], state["sparse_opt"], t).items()}
                for t in HOST_TABLES})

    served, repaired = [], []
    real_rows_for = port_main._HostRowPrefetcher.rows_for
    real_refresh = EmbeddingEngine.host_refresh

    def rows_for(self, batch):
        served.append(self._batch is batch and (
            self._out is not None or self._thread is not None))
        return real_rows_for(self, batch)

    def refresh(self, tables, gathered, touched):
        before = {gk: r.clone() for gk, (r, _) in gathered.items()}
        real_refresh(self, tables, gathered, touched)
        repaired.append(sum(int((before[gk] != r).any(1).sum())
                            for gk, (r, _) in gathered.items()))

    out = {}
    for name, env, patches in (
            ("on", "1", [mock.patch.object(port_main._HostRowPrefetcher,
                                           "rows_for", rows_for),
                         mock.patch.object(EmbeddingEngine, "host_refresh",
                                           refresh)]),
            ("off", "0", []),
            ("unrepaired", "1", [mock.patch.object(
                EmbeddingEngine, "host_refresh",
                lambda self, *a: None)])):
        path, _ = cfg(name)
        with mock.patch.dict(os.environ, {"TZREC_HOST_PREFETCH": env}):
            for p in patches:
                p.start()
            try:
                result = port_main.train_and_evaluate(
                    path, fine_tune_checkpoint=init, device="cpu")
            finally:
                for p in patches:
                    p.stop()
        model_dir = str(root / name)
        out[name] = (result, torch.load(checkpoint_util.latest_checkpoint(
            model_dir), weights_only=True), _eval_lines(model_dir))
    return out, jax_ref, served, repaired, _eval_lines(str(root / "jax"))


def test_host_prefetch_equals_the_run_without_it(host_runs):
    out, _, served, repaired, _ = host_runs
    # 3 epochs of 6 steps: each epoch's first batch is gathered in its
    # step, the other 5 come from the prefetch; the repair re-reads rows
    assert served == ([False] + [True] * 5) * 3
    assert sum(repaired) > 0
    (r_on, ck_on, ev_on), (r_off, ck_off, ev_off) = out["on"], out["off"]
    assert r_on == r_off and ev_on == ev_off
    assert ck_on["step"] == ck_off["step"] == 18
    for k in ck_off["model"]:
        assert torch.equal(ck_on["model"][k], ck_off["model"][k]), k
    for t in ck_off["sparse_opt"]:
        for k in ck_off["sparse_opt"][t]:
            assert torch.equal(ck_on["sparse_opt"][t][k],
                               ck_off["sparse_opt"][t][k]), (t, k)
    # without the repair the prefetched rows are stale: another result
    ck_bad = out["unrepaired"][1]
    assert not all(torch.equal(ck_bad["model"][k], ck_off["model"][k])
                   for k in ck_off["model"])


@pytest.mark.parametrize("which", ["on", "off"])
def test_host_prefetch_matches_jax(host_runs, which):
    out, (jax_sd, jax_opt), _, _, jax_eval = host_runs
    _, ck, ev = out[which]
    for k, v in jax_sd.items():
        tol = 1e-5 if k.split(".")[-1] in HOST_TABLES else 1e-4
        assert_close_to_max(ck["model"][k].numpy(), v.numpy(), k, tol)
    for t in HOST_TABLES:
        for k, v in jax_opt[t].items():
            assert_close_to_max(ck["sparse_opt"][t][k].numpy().reshape(
                v.shape), v, f"{t}.{k}", 1e-5)
    assert [e["global_step"] for e in ev] == [
        e["global_step"] for e in jax_eval]
    np.testing.assert_allclose(ev[-1]["auc"], jax_eval[-1]["auc"],
                               rtol=1e-4, atol=1e-5)

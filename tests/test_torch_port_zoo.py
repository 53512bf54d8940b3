"""The Criteo ranking and multi-task zoo of the port against the JAX
package (fp32, CPU; one config text and the same Arrow columns for
both; the JAX weights cross through utils/convert.py).

- Per model (WideAndDeep, DLRM, DCN v1/v2, MaskNet parallel and serial,
  SimpleMultiTask, MMoE, PLE with two extraction layers, DBMTL with and
  without its MaskNet bottom), built from narrowed copies of the
  criteo_synth configs: the forward's ``logits*``/``probs*`` within
  rtol 1e-5 / atol 1e-6; two train steps (``rowwise_adagrad`` and
  ``adam``, tables on both sides of the dense lane): losses, every dense
  parameter, the tables and their row state (through ``extract_table``)
  within rtol 1e-4 / atol 1e-5, the DeepFM tests' tolerance; the eval
  metrics (names and values, ``grouped_auc`` included) on the same
  predictions within 1e-12.
- Per module with new arithmetic (``InteractionArch``, ``Cross``,
  ``CrossV2``, ``MaskNetModule`` parallel and serial, ``MMoE``,
  ``ExtractionNet``): the forward within rtol 1e-5 / atol 1e-6.
- ``GroupedAUC`` and ``AUC`` equal the JAX ones within 1e-12 (groups of
  one class, ties, int64 keys).
- ``train_and_evaluate`` of both packages from the same weights on the
  same parquet files: the same metric names, values within rtol 1e-4;
  ``predict_checkpoint`` writes every tower's columns, equal to the eval
  step's outputs.
- ``synthetic.generate`` writes the JAX package's rows; the seven config
  copies equal the JAX originals but for their paths.

Both engines merge co-keyed tables, as they do by default (Wide&Deep's
WIDE and DEEP tables of a feature become one table), and the JAX
engine's dense lane takes the tables of at most ``ZOO_DENSE_LANE`` rows,
as the port's."""

import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import (
    ZOO_DENSE_LANE,
    ZOO_MODELS,
    converted_state,
    jax_model_and_state,
    jax_train_setup,
    zoo_cols,
    zoo_config_text,
    zoo_table_names,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu import metrics as jax_metrics
from torcheasyrec_tpu.benchmark import synthetic as jax_synthetic
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.modules import extraction_net as jax_extraction_net
from torcheasyrec_tpu.modules import interaction as jax_interaction
from torcheasyrec_tpu.modules import masknet as jax_masknet
from torcheasyrec_tpu.modules import mmoe as jax_mmoe
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch import metrics as port_metrics
from torcheasyrec_tpu_torch.benchmark import synthetic
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules import extraction_net, interaction
from torcheasyrec_tpu_torch.modules import masknet, mmoe
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    create_dense_optimizer,
)
from torcheasyrec_tpu_torch.protos import pipeline_pb2 as port_pb2
from torcheasyrec_tpu_torch.utils import checkpoint_util, convert
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 64
LABELS = ["label", "conversion"]
N_STEPS = 2
EVAL_ROWS = 1000
CLASSES = {
    "wide_and_deep": "WideAndDeep", "dlrm": "DLRM", "dcn_v1": "DCNV1",
    "dcn_v2": "DCNV2", "mask_net": "MaskNet", "mask_net_serial": "MaskNet",
    "simple_multi_task": "SimpleMultiTask", "mmoe": "MMoE", "ple": "PLE",
    "dbmtl": "DBMTL", "dbmtl_masknet": "DBMTL",
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = os.path.join(REPO, "torcheasyrec_tpu_torch", "benchmark",
                            "configs")
JAX_CONFIGS = os.path.join(REPO, "torcheasyrec_tpu", "benchmark", "configs")
CONFIG_COPIES = ["wide_and_deep", "dlrm", "dcn_v2", "masknet", "mmoe", "ple",
                 "dbmtl"]


@pytest.fixture(scope="module")
def jax_engine_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TZREC_DENSE_LANE", str(ZOO_DENSE_LANE))
        mp.setenv("TZREC_PACKED", "1")
        yield


def _port_model(text, **kw):
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, dense_lane_rows=ZOO_DENSE_LANE, **kw)
    return cfg, model, features, sparse_sched


def _as_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(ZOO_MODELS))
def zoo_run(request, jax_engine_env):
    """One model in both packages from the JAX package's initial weights:
    the forward of one batch, then two train steps on two more."""
    key = request.param
    text = zoo_config_text(key, BATCH)
    _, jmodel, jfeatures, jstate, jstep = jax_train_setup(text)
    cfg, model, features, sparse_sched = _port_model(text)
    tables = zoo_table_names(key)
    model.load_state_dict(converted_state(
        jmodel, jstate["dense"], jstate["tables"], tables))
    jparser = JaxParser(jfeatures, labels=LABELS)
    parser = DataParser(features, labels=LABELS)

    cols = zoo_cols(BATCH, seed=3)
    jbatch, batch = jparser.parse_to_batch(cols), parser.parse_to_batch(cols)
    jpreds, jlosses = jax_main.make_eval_step(jmodel, jnp.float32)(
        {"dense": jstate["dense"], "tables": jstate["tables"]}, jbatch)
    preds, losses = port_main.make_eval_step(model)(batch)

    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, list(model.parameters()))
    state = port_main._init_state(model)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    step_losses, jstep_losses = [], []
    for i in range(N_STEPS):
        c = zoo_cols(BATCH, seed=100 + i)
        jstate, jm, _ = jstep(jstate, jparser.parse_to_batch(c),
                              jax.random.key(0))
        jstep_losses.append({k: float(v) for k, v in jm.items()
                             if not k.startswith("__")})
        state, m = step(state, parser.parse_to_batch(c))
        step_losses.append({k: float(v) for k, v in m.items()})
    return dict(key=key, jmodel=jmodel, model=model, jbatch=jbatch,
                batch=batch, jpreds=_as_np(jpreds), preds=preds,
                jlosses=jlosses, losses=losses, jstate=jstate, state=state,
                jstep_losses=jstep_losses, step_losses=step_losses,
                tables=tables)


def test_zoo_model_builds_from_config_text(zoo_run):
    model, jmodel = zoo_run["model"], zoo_run["jmodel"]
    assert isinstance(model, BaseModel)
    assert type(model).__name__ == type(jmodel).__name__ == CLASSES[
        zoo_run["key"]]
    eg, jeg = model.embedding_group, jmodel.embedding_group
    assert eg.group_names() == jeg.group_names()
    for g in eg.group_names():
        assert eg.group_dims(g) == jeg.group_dims(g), g
    assert set(eg.tables) == set(zoo_run["tables"])
    # rowwise_adagrad: every fp32 group packs
    assert all(g.packed for g in eg.engine.groups.values())


def test_zoo_forward_matches_jax(zoo_run):
    preds, jpreds = zoo_run["preds"], zoo_run["jpreds"]
    assert set(preds) == set(jpreds)
    assert any(k.startswith("probs") for k in preds)
    for k, v in preds.items():
        assert v.dtype == torch.float32 and v.shape == (BATCH,), k
        np.testing.assert_allclose(v.numpy(), jpreds[k], err_msg=k,
                                   **FWD_TOL)
    losses, jlosses = zoo_run["losses"], zoo_run["jlosses"]
    assert set(losses) == set(jlosses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   err_msg=k, **FWD_TOL)


def test_zoo_two_train_steps_match_jax(zoo_run):
    for ours, ref in zip(zoo_run["step_losses"], zoo_run["jstep_losses"]):
        assert set(ours) == set(ref)
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    model, jstate = zoo_run["model"], zoo_run["jstate"]
    jdense = convert.from_jax_state(jax.device_get(jstate["dense"]), {})
    params = dict(model.named_parameters())
    assert set(params) == set(jdense)
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), jdense[n].numpy(),
                                   err_msg=n, **TOL)
    jeng = zoo_run["jmodel"].embedding_group.engine
    eg = model.embedding_group
    fused = eg.engine_tables()
    for name in zoo_run["tables"]:
        ref = np.asarray(jeng.extract_table(jstate["tables"], name))
        got = eg.engine.extract_table(fused, name).numpy()
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)
        jacc = np.asarray(jeng.extract_table_state(
            jstate["tables"], jstate["sparse_opt"], name)["acc"])
        acc = eg.engine.extract_table_state(
            fused, zoo_run["state"]["sparse_opt"], name)["acc"]
        np.testing.assert_allclose(acc.numpy(), jacc, err_msg=name, **TOL)
        assert float(np.abs(jacc).max()) > 0, name


def test_zoo_metrics_match_jax(zoo_run):
    """The eval metrics of both packages on the JAX predictions: the same
    names (``grouped_auc_<key>``, per tower ``<metric>_<tower>``) and the
    same values."""
    model, jmodel = zoo_run["model"], zoo_run["jmodel"]
    jpreds = zoo_run["jpreds"]
    ours, ref = model.init_metrics(), jmodel.init_metrics()
    for _ in range(2):  # two updates accumulate
        model.update_metrics(
            ours, {k: torch.from_numpy(v.copy()) for k, v in jpreds.items()},
            zoo_run["batch"])
        jmodel.update_metrics(ref, jpreds, jax.device_get(zoo_run["jbatch"]))
    got, want = model.compute_metrics(ours), jmodel.compute_metrics(ref)
    assert list(got) == list(want)
    assert any(k.startswith("grouped_auc_cat_1") for k in got)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


# --- modules ----------------------------------------------------------------


def _load(module, jparams):
    module.load_state_dict(
        convert.from_jax_state(jax.device_get(jparams), {}), strict=True)
    return module


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _module_case(name):
    g = torch.Generator().manual_seed(0)
    key = jax.random.key(1)
    ctx, dt = JM.eval_ctx(), torch.float32
    if name == "interaction_arch":
        x = _x(8, 5, 4)
        ref = jax_interaction.InteractionArch(5)({}, jnp.asarray(x), ctx)
        return interaction.InteractionArch(5)(torch.from_numpy(x)), ref
    if name == "cross":
        x = _x(8, 12)
        jm = jax_interaction.Cross(12, 3)
        p = jm.init(key)
        # nonzero biases, so a swapped rule shows
        p = jax.tree_util.tree_map(lambda a: a + 0.1, p)
        m = _load(interaction.Cross(12, 3, g), p)
        return m(torch.from_numpy(x)), jm(p, jnp.asarray(x), ctx)
    if name == "cross_v2":
        x = _x(8, 12)
        jm = jax_interaction.CrossV2(12, 3, 4)
        p = jm.init(key)
        m = _load(interaction.CrossV2(12, 3, 4, g), p)
        return m(torch.from_numpy(x), dt), jm(p, jnp.asarray(x), ctx)
    if name in ("masknet_parallel", "masknet_serial"):
        x = _x(8, 20)
        kw = dict(feature_dim=20, n_mask_blocks=3,
                  mask_block={"hidden_dim": 16, "aggregation_dim": 6},
                  top_mlp={"hidden_units": [12, 8]},
                  use_parallel=name == "masknet_parallel")
        jm = jax_masknet.MaskNetModule(**kw)
        p = jm.init(key)
        m = _load(masknet.MaskNetModule(generator=g, **kw), p)
        return m(torch.from_numpy(x), dt), jm(p, jnp.asarray(x), ctx)
    if name == "mmoe":
        x = _x(8, 20)
        kw = dict(in_features=20, expert_mlp={"hidden_units": [16, 8]},
                  num_expert=3, num_task=2,
                  gate_mlp={"hidden_units": [6]})
        jm = jax_mmoe.MMoE(**kw)
        p = jm.init(key)
        m = _load(mmoe.MMoE(generator=g, **kw), p)
        return (torch.stack(m(torch.from_numpy(x), dt)),
                jnp.stack(jm(p, jnp.asarray(x), ctx)))
    if name == "extraction_net":
        xs = [_x(8, 20, seed=i) for i in range(3)]
        kw = dict(in_task=[20, 20], in_share=20, num_task=2,
                  expert_num_per_task=2, share_num=2,
                  task_expert_net={"hidden_units": [16, 8]},
                  share_expert_net={"hidden_units": [16, 8]})
        jm = jax_extraction_net.ExtractionNet(network_name="l1", **kw)
        p = jm.init(key)
        m = _load(extraction_net.ExtractionNet(generator=g, **kw), p)
        tasks, share = m([torch.from_numpy(a) for a in xs[:2]],
                         torch.from_numpy(xs[2]), dt)
        jtasks, jshare = jm(p, [jnp.asarray(a) for a in xs[:2]],
                            jnp.asarray(xs[2]), ctx)
        return torch.stack(tasks + [share]), jnp.stack(jtasks + [jshare])
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "interaction_arch", "cross", "cross_v2", "masknet_parallel",
    "masknet_serial", "mmoe", "extraction_net"])
def test_module_matches_jax(name):
    got, ref = _module_case(name)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, **FWD_TOL)


def test_interaction_arch_orders_pairs_as_the_upper_triangle():
    x = torch.arange(1.0, 4.0).reshape(1, 3, 1)  # features 1, 2, 3
    assert interaction.InteractionArch(3)(x).tolist() == [[2.0, 3.0, 6.0]]


# --- metrics ----------------------------------------------------------------


def _grouped_case(case, r):
    n = 700
    if case == "int64_keys":
        keys = r.integers(0, 40, n).astype(np.int64) * 10**12
        return r.random(n), r.random(n) < 0.3, keys
    if case == "ties":
        return (np.round(r.random(n), 1).astype(np.float32),
                (r.random(n) < 0.5).astype(np.float32),
                r.integers(0, 12, n))
    if case == "one_class_groups":
        keys = r.integers(0, 30, n)
        labels = (r.random(n) < 0.4) & (keys % 3 != 0)  # 1/3: negatives only
        labels |= keys == 4  # and one group of positives only
        return r.random(n), labels, keys
    if case == "singletons":
        return r.random(50), r.random(50) < 0.5, np.arange(50)
    if case == "zipf_keys":
        keys = np.minimum((r.random(5000) ** 2.2 * 3000).astype(np.int64),
                          2999)
        return r.random(5000).astype(np.float32), r.random(5000) < 0.2, keys
    raise KeyError(case)


@pytest.mark.parametrize("case", ["int64_keys", "ties", "one_class_groups",
                                  "singletons", "zipf_keys"])
def test_grouped_auc_and_auc_match_jax(case):
    preds, labels, keys = _grouped_case(case, np.random.default_rng(9))
    ours, ref = port_metrics.GroupedAUC("k"), jax_metrics.GroupedAUC("k")
    for m in (ours, ref):
        m.update(preds[:100], labels[:100], grouping_key=keys[:100])
        m.update(preds[100:], labels[100:], grouping_key=keys[100:])
    got, want = ours.compute(), ref.compute()
    if case == "singletons":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert abs(got - want) <= 1e-12, (got, want)
    a, b = port_metrics.AUC(), jax_metrics.AUC()
    for m in (a, b):
        m.update(preds, labels)
    assert abs(a.compute() - b.compute()) <= 1e-12


def test_create_metric_names_grouped_auc_by_its_key():
    from torcheasyrec_tpu_torch.protos import metric_pb2

    cfg = text_format.Parse('grouped_auc { grouping_key: "cat_10" }',
                            metric_pb2.MetricConfig())
    made = port_metrics.create_metric(cfg)
    assert made["name"] == "grouped_auc_cat_10"
    assert isinstance(made["metric"], port_metrics.GroupedAUC)


# --- the entry points -------------------------------------------------------


@pytest.fixture(scope="module")
def zoo_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    for i, n in enumerate((100, 92)):
        pq.write_table(pa.table(zoo_cols(n, seed=30 + i)),
                       os.path.join(root, f"train-{i}.parquet"))
    # 1 000 eval rows: one pair of predictions swapping order moves the AUC
    # by 1 / (positives x negatives), about 5e-6 here
    pq.write_table(pa.table(zoo_cols(EVAL_ROWS, seed=40)),
                   os.path.join(root, "eval.parquet"))
    return str(root)


def _zoo_config(path, model, model_dir, root):
    text = zoo_config_text(
        model, 32, model_dir=model_dir, num_steps=5,
        train_path=os.path.join(root, "train-*.parquet"),
        eval_path=os.path.join(root, "eval.parquet"),
        train_extra="  save_checkpoints_steps: 3")
    with open(path, "w") as f:
        f.write(text)
    return path, text


def _eval_lines(model_dir):
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        return [json.loads(line) for line in f]


def test_train_and_evaluate_matches_jax(zoo_files, tmp_path, monkeypatch,
                                        jax_engine_env):
    """DBMTL (two towers, a relation tower, ``grouped_auc`` on one tower):
    5 steps of 32 over two files, a save and an eval at step 3 and at the
    end, in both packages from the JAX init; then ``predict_checkpoint``
    of the port's last checkpoint."""
    model = "dbmtl"
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_dir = str(tmp_path / "jax")
    jax_cfg, text = _zoo_config(str(tmp_path / "jax.config"), model, jax_dir,
                                zoo_files)
    jax_main.train_and_evaluate(jax_cfg)

    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = str(tmp_path / "jax_init.pt")
    torch.save(converted_state(jmodel, dense, tables,
                               zoo_table_names(model)), init)
    port_dir = str(tmp_path / "port")
    port_cfg, _ = _zoo_config(str(tmp_path / "port.config"), model, port_dir,
                              zoo_files)
    result = port_main.train_and_evaluate(port_cfg, fine_tune_checkpoint=init,
                                          device="cpu")
    assert result["step"] == 5.0
    ours, ref = _eval_lines(port_dir), _eval_lines(jax_dir)
    assert [r["global_step"] for r in ours] == [
        r["global_step"] for r in ref] == [3, 5]
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)

    out = str(tmp_path / "pred.parquet")
    eval_path = os.path.join(zoo_files, "eval.parquet")
    assert port_main.predict_checkpoint(port_cfg, eval_path, out,
                                        device="cpu") == EVAL_ROWS
    pred = pq.read_table(out)
    m, features = port_main.build_model(parse_pipeline_config(text), "cpu")
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(port_dir), m)
    table = pq.read_table(eval_path)
    batch = DataParser(features, labels=LABELS).parse_to_batch(
        {k: table.column(k).combine_chunks() for k in table.column_names})
    preds, _ = port_main.make_eval_step(m, with_loss=False)(batch)
    assert set(pred.column_names) == set(preds)
    for k, v in preds.items():
        np.testing.assert_array_equal(pred.column(k).to_numpy(), v.numpy(),
                                      err_msg=k)


# --- data and configs -------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_synthetic_generate_writes_the_jax_rows(seed, tmp_path):
    ours = synthetic.generate(str(tmp_path / "port.parquet"), 4096, seed=seed)
    ref = jax_synthetic.generate(str(tmp_path / "jax.parquet"), 4096,
                                 seed=seed)
    a, b = pq.read_table(ours[0]), pq.read_table(ref[0])
    assert a.column_names == b.column_names
    assert "conversion" in a.column_names
    assert a.equals(b)
    assert synthetic.CRITEO_BUCKETS == jax_synthetic.CRITEO_BUCKETS


def test_ensure_dataset_names_the_jax_files(tmp_path):
    got = synthetic.ensure_dataset(str(tmp_path), 64, 32)
    assert {k: os.path.basename(v) for k, v in got.items()} == {
        "train": "criteo_synth_train_64_v3.parquet",
        "eval": "criteo_synth_eval_32_v3.parquet",
        "items": "criteo_synth_items.parquet"}
    assert pq.read_table(got["eval"]).num_rows == 32


def _without_paths(text, pb2):
    cfg = text_format.Parse(text, pb2.EasyRecConfig())
    for field in ("train_input_path", "eval_input_path", "model_dir"):
        cfg.ClearField(field)
    return cfg.SerializePartialToString(deterministic=True)


@pytest.mark.parametrize("name", CONFIG_COPIES)
def test_config_copy_equals_the_jax_original_but_its_paths(name):
    with open(os.path.join(PORT_CONFIGS, "criteo_synth",
                           f"{name}.config")) as f:
        ours = f.read()
    with open(os.path.join(JAX_CONFIGS, "criteo_synth",
                           f"{name}.config")) as f:
        ref = f.read()
    assert _without_paths(ours, port_pb2) == _without_paths(ref, jax_pb2)
    cfg = parse_pipeline_config(ours)
    assert cfg.train_input_path.startswith("criteo_synth_data/")
    assert cfg.model_dir == f"criteo_synth_model/{name}"
    with open(os.path.join(PORT_CONFIGS, "base_eval_metric.json")) as f:
        labels = json.load(f)
    with open(os.path.join(JAX_CONFIGS, "base_eval_metric.json")) as f:
        jax_labels = json.load(f)
    key = f"criteo_synth/{name}.config"
    assert (labels[f"torcheasyrec_tpu_torch/benchmark/configs/{key}"]
            == jax_labels[f"torcheasyrec_tpu/benchmark/configs/{key}"])
    # the full-width model builds
    model, _ = port_main.build_model(cfg, "cpu")
    assert type(model).__name__ == {
        "wide_and_deep": "WideAndDeep", "dlrm": "DLRM", "dcn_v2": "DCNV2",
        "masknet": "MaskNet", "mmoe": "MMoE", "ple": "PLE",
        "dbmtl": "DBMTL"}[name]


@pytest.mark.parametrize("extra,match", [
    ("  use_pareto_loss_weight: true\n", "Pareto"),
    ('  task_towers { tower_name: "x" task_space_indicator_label: "label"'
     " losses { binary_cross_entropy {} } }\n", "task_space_indicator"),
])
def test_unported_multi_task_options_raise(extra, match, tmp_path):
    """Pareto loss weights and ``task_space_indicator_label`` are ported
    now (tests/test_torch_port_zoo_rest.py holds them against the JAX
    package): each case's config builds. So do a dense embedding
    (AutoDis) and a vocab file, one a case, until they were ported
    (tests/test_torch_port_dense_emb.py holds them against the JAX
    package). So does fg_mode FG_NORMAL since it was ported. A Kafka
    input is ported too (it raises ImportError here, without
    confluent_kafka); an ODPS input, a stub in both packages, raises
    NotImplementedError (host-offloaded tables, the second case's until
    they were ported, are held in tests/test_torch_port_host_offload.py)."""
    text = zoo_config_text("mmoe")
    if "pareto" in extra:
        text = text.replace("model_config {", "model_config {\n" + extra, 1)
    else:
        text = text.replace("    num_expert: 3\n", "    num_expert: 3\n" + extra)
    _, model, _, _ = _port_model(text)
    if match == "Pareto":
        assert model._use_pareto
        ported = zoo_config_text("mmoe").replace(
            'raw_feature { feature_name: "int_0" }',
            'raw_feature { feature_name: "int_0" embedding_dim: 4 autodis {'
            " num_channels: 3 } }")
        assert ported != zoo_config_text("mmoe")
        _, model, _, _ = _port_model(ported)
        assert type(model.embedding_group.dense_emb["int_0"]).__name__ == (
            "AutoDisEmbedding")
        # FG_NORMAL is ported (tests/test_torch_port_fg_*.py hold it
        # against the JAX package): the config builds, its features in
        # FG_NORMAL mode read the columns of their names
        _, _, features, _ = _port_model(zoo_config_text("mmoe").replace(
            "fg_mode: FG_NONE", "fg_mode: FG_NORMAL"))
        assert all(f._fg_mode == 2 and f.inputs == [f.name]
                   for f in features)
        return
    assert [t.tower_name for t in model._task_tower_cfgs
            if t.task_space_indicator_label] == ["x"]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("a\nb\n")
    ported = zoo_config_text("mmoe").replace(
        'feature_name: "cat_0" num_buckets: 500 ', 'feature_name: "cat_0" '
        f'vocab_file: "{vocab}" ')
    assert ported != zoo_config_text("mmoe")
    _, model, _, _ = _port_model(ported)
    assert model.embedding_group.tables["cat_0_emb"].shape[0] == 2
    from torcheasyrec_tpu_torch.datasets.dataset import create_reader
    from torcheasyrec_tpu_torch.protos import data_pb2

    # Kafka is ported (tests/test_torch_port_kafka.py): without
    # confluent_kafka its reader raises ImportError; ODPS is a stub in
    # both packages
    with mock.patch.dict(sys.modules, {"confluent_kafka": None}):
        with pytest.raises(ImportError, match="confluent-kafka"):
            create_reader("kafka://b/topic", 8,
                          dataset_type=data_pb2.DatasetType.KafkaDataset)
    with pytest.raises(NotImplementedError, match="OdpsDataset"):
        create_reader("topic", 8,
                      dataset_type=data_pb2.DatasetType.OdpsDataset)

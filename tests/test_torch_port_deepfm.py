"""DeepFM of the port against the JAX package (fp32, CPU, one config
text and the same Arrow columns for both; the JAX weights cross through
utils/convert.py).

- FM, the RankModel heads and losses, the whole DeepFM forward and its
  dense gradients: rtol 1e-4 / atol 1e-5 (the same formulas in another
  library's fp32 arithmetic).
- ``_auc``: bit-equal, ties included.
- A small DeepFM trained for 40 steps in both packages from the same
  weights and batches: every step's loss within 2e-3 relative, eval AUC
  within 0.003.
- ``train_and_evaluate`` evaluates on ``eval_input_path`` and returns
  the metrics; ``evaluate`` of its checkpoint gives them again; the
  checkpoint of a packed engine loads into an unpacked one and back with
  equal tables and row state."""

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
    DEEPFM_BUCKETS,
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    jax_model_and_state,
    jax_train_setup,
)
from torcheasyrec_tpu import metrics as jax_metrics
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.main import make_eval_step as jax_eval_step
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules.fm import FactorizationMachine as JaxFM
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch import metrics as port_metrics
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
from torcheasyrec_tpu_torch.models.deepfm import DeepFM
from torcheasyrec_tpu_torch.modules.fm import FactorizationMachine
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    create_dense_optimizer,
)
from torcheasyrec_tpu_torch.protos import metric_pb2
from torcheasyrec_tpu_torch.utils import checkpoint_util, convert
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 64
TABLES = deepfm_table_names()


def test_fm_matches_jax():
    x = np.random.default_rng(0).normal(size=(5, 6, 8)).astype(np.float32)
    ref = np.asarray(JaxFM()({}, jnp.asarray(x), JM.eval_ctx()))
    got = FactorizationMachine()(torch.from_numpy(x))
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _port_model(text, jmodel=None, dense=None, tables=None, **kw):
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, **kw)
    if jmodel is not None:
        model.load_state_dict(converted_state(jmodel, dense, tables, TABLES))
    return cfg, model, features, sparse_sched


@pytest.fixture(scope="module")
def deepfm_pair():
    text = deepfm_config_text(BATCH)
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(text)
    _, model, features, _ = _port_model(text, jmodel, dense, tables)
    cols = deepfm_cols(BATCH, seed=3)
    jbatch = JaxParser(jfeatures, labels=["label"]).parse_to_batch(cols)
    batch = DataParser(features, labels=["label"]).parse_to_batch(cols)
    return jmodel, dense, tables, jbatch, model, batch


def test_deepfm_builds_wide_and_deep_tables(deepfm_pair):
    jmodel, _, _, _, model, _ = deepfm_pair
    assert isinstance(model, DeepFM)
    eg, jeg = model.embedding_group, jmodel.embedding_group
    for group in ("wide", "fm", "deep"):
        assert eg.group_dims(group) == jeg.group_dims(group)
    assert set(eg.tables) == set(TABLES)
    assert eg.tables["cat_0_emb__wide"].shape == (DEEPFM_BUCKETS[0], 4)
    # rowwise_adagrad: each feature's WIDE (dim 4) and DEEP (dim 8) tables
    # merge into one dim-12 table, as in the JAX engine; its slot holds 12
    # weights and an accumulator per segment
    assert {gk: (g.packed, g.slot) for gk, g in eg.engine.groups.items()} == {
        "d12_s8.4": (True, 14)}
    assert {gk.replace("_data_parallel", "")
            for gk in jeg.engine.groups} == set(eg.engine.groups)
    for gk, store in eg.engine_tables().items():
        assert store.shape == (eg.engine.groups[gk].p_rows, 128)


def test_deepfm_forward_matches_jax(deepfm_pair):
    jmodel, dense, tables, jbatch, model, batch = deepfm_pair
    jpreds, jlosses = jax_eval_step(jmodel, jnp.float32)(
        {"dense": dense, "tables": tables}, jbatch)
    preds, losses = port_main.make_eval_step(model)(batch)
    assert set(preds) == set(jpreds) == {"logits", "probs"}
    for k in preds:
        assert preds[k].shape == (BATCH,) and preds[k].dtype == torch.float32
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(jpreds[k]),
                                   err_msg=k, **TOL)
    assert set(losses) == set(jlosses) == {"binary_cross_entropy"}
    np.testing.assert_allclose(float(losses["binary_cross_entropy"]),
                               float(jlosses["binary_cross_entropy"]),
                               rtol=1e-5)


def test_deepfm_dense_gradients_match_jax(deepfm_pair):
    jmodel, dense, tables, jbatch, model, batch = deepfm_pair

    def jax_loss(d):
        preds = jmodel.forward(d, tables, jbatch, JM.eval_ctx())
        return jmodel.total_loss(jmodel.loss(preds, jbatch))

    jgrads = convert.from_jax_state(
        jax.device_get(jax.grad(jax_loss)(dense)), {})
    eg = model.embedding_group
    with torch.no_grad():
        emb_out, _ = eg.lookup(batch)
    preds = model.predict(eg.assemble(emb_out, batch, model.compute_dtype),
                          batch)
    total = model.total_loss(model.loss(preds, batch))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    assert set(grads) == set(jgrads) and len(grads) == 10
    for n, g in grads.items():
        scale = float(jgrads[n].abs().max())
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0), err_msg=n)


HEADS = {
    "sigmoid": ("num_class: 1", "binary_cross_entropy {}", 1),
    "softmax_2": ("num_class: 2", "softmax_cross_entropy {}", 2),
    "softmax_1": ("num_class: 1", "softmax_cross_entropy {}", 2),
    "multiclass": ("num_class: 3", "softmax_cross_entropy "
                   "{ label_smoothing: 0.1 }", 3),
    "smoothed_bce": ("num_class: 1", "binary_cross_entropy "
                     "{ label_smoothing: 0.2 }", 1),
    "l2": ("num_class: 1", "l2_loss {}", 1),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_rank_model_heads_and_weighted_losses_match_jax(head):
    """``_output_to_prediction`` and ``loss`` on given outputs, with a
    sample-weight column."""
    num_class, loss, width = HEADS[head]
    text = deepfm_config_text(BATCH).replace("num_class: 1", num_class)
    text = text.replace("binary_cross_entropy {}", loss).replace(
        '  label_fields: "label"',
        '  label_fields: "label"\n  sample_weight_fields: "w"')
    _, jmodel, jfeatures, _, _ = jax_model_and_state(text)
    _, model, features, _ = _port_model(text)
    r = np.random.default_rng(5)
    cols = deepfm_cols(BATCH, seed=4)
    cols["w"] = pa.array(r.random(BATCH).astype(np.float32))
    if head == "multiclass":
        cols["label"] = pa.array(r.integers(0, 3, BATCH).astype(np.float32))
    jbatch = JaxParser(jfeatures, labels=["label"],
                       sample_weights=["w"]).parse_to_batch(cols)
    batch = DataParser(features, labels=["label"],
                       sample_weights=["w"]).parse_to_batch(cols)
    out = r.normal(size=(BATCH, width)).astype(np.float32)
    jpreds = jmodel._output_to_prediction(jnp.asarray(out))
    preds = model._output_to_prediction(torch.from_numpy(out))
    assert set(preds) == set(jpreds)
    for k in preds:
        assert preds[k].shape == tuple(jpreds[k].shape), k
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(jpreds[k]),
                                   err_msg=k, **TOL)
    jlosses = jmodel.loss(jpreds, jbatch)
    losses = model.loss(preds, batch)
    assert set(losses) == set(jlosses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("text,match", [
    (deepfm_config_text().replace(
        "  num_class: 1", "  variational_dropout {}\n  num_class: 1"),
     "variational_dropout"),
    (deepfm_config_text().replace(
        "deep { hidden_units: [32, 16] }",
        "deep { hidden_units: [32, 16] use_bn: true }"), "batch norm"),
    (deepfm_config_text().replace(
        "deep { hidden_units: [32, 16] }",
        'deep { hidden_units: [32, 16] activation: "nn.Dice" }'), "Dice"),
])
def test_unported_rank_options_raise(text, match, tmp_path):
    """Variational dropout, MLP batch norm and Dice are ported now
    (tests/test_torch_port_zoo_rest.py holds them against the JAX
    package): each case's config builds with its module. So do an MLP
    dense embedding and a vocab file, the next two cases' until they were
    ported (tests/test_torch_port_dense_emb.py holds them against the JAX
    package), and fg_mode FG_NORMAL since it was ported. A Kafka input is
    ported too (it raises ImportError here, without confluent_kafka); an
    ODPS input, a stub in both packages, raises NotImplementedError
    (host-offloaded tables, the first case's until they were ported, are
    held in tests/test_torch_port_host_offload.py)."""
    _, model, _, _ = _port_model(text)
    if match == "variational_dropout":
        assert sorted(model.variational_dropout) == ["deep", "fm", "wide"]
        _, model, _, _ = _port_model(deepfm_config_text().replace(
            'raw_feature { feature_name: "int_0" }',
            'raw_feature { feature_name: "int_0" embedding_dim: 4 mlp {} }'))
        assert type(model.embedding_group.dense_emb["int_0"]).__name__ == (
            "MLPEmbedding")
    elif match == "batch norm":
        assert all(layer.bn is not None for layer in model.deep_mlp.layers)
        vocab = tmp_path / "vocab.txt"
        vocab.write_text("a\nb\nc 11\n")
        _, model, _, _ = _port_model(deepfm_config_text().replace(
            'feature_name: "cat_0" num_buckets: 3000 ',
            f'feature_name: "cat_0" vocab_file: "{vocab}" '))
        assert model.embedding_group.tables["cat_0_emb"].shape[0] == 12
    else:
        assert all(type(layer.act).__name__ == "Dice"
                   for layer in model.deep_mlp.layers)
    if match == "variational_dropout":
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
        return
    # FG_NORMAL is ported (tests/test_torch_port_fg_*.py hold it against
    # the JAX package): the config builds in FG_NORMAL mode
    _, _, features, _ = _port_model(deepfm_config_text().replace(
        "fg_mode: FG_NONE", "fg_mode: FG_NORMAL"))
    assert all(f._fg_mode == 2 and f.inputs == [f.name] for f in features)


def test_dense_feature_in_wide_group_raises():
    text = deepfm_config_text().replace(
        '    group_type: WIDE', '    feature_names: "int_0"\n'
        '    group_type: WIDE')
    with pytest.raises(ValueError, match="wide group"):
        _port_model(text)


AUC_CASES = {
    "random": lambda r: (r.random(500), r.random(500) < 0.3),
    "ties": lambda r: (np.round(r.random(500), 1), r.random(500) < 0.5),
    "all_tied": lambda r: (np.full(50, 0.5), r.random(50) < 0.5),
    "separable": lambda r: (np.arange(40) / 40.0, np.arange(40) >= 25),
    "float32_probs": lambda r: (r.random(300).astype(np.float32),
                                (r.random(300) < 0.1).astype(np.float32)),
    "one_class": lambda r: (r.random(20), np.zeros(20, bool)),
}


@pytest.mark.parametrize("case", sorted(AUC_CASES))
def test_auc_matches_jax_bit_for_bit(case):
    preds, labels = AUC_CASES[case](np.random.default_rng(2))
    ref = jax_metrics._auc(preds, labels)
    got = port_metrics._auc(preds, labels)
    if case == "one_class":
        assert np.isnan(ref) and np.isnan(got)
        return
    assert got == ref
    # the accumulating metric over two uneven updates
    m, jm = port_metrics.AUC(), jax_metrics.AUC()
    for metric in (m, jm):
        metric.update(preds[:7], labels[:7])
        metric.update(preds[7:], labels[7:])
    assert m.compute() == jm.compute() == ref
    m.reset()
    m.update(preds[:30], labels[:30])
    assert m.compute() == jax_metrics._auc(preds[:30], labels[:30])


def test_create_metric_ports_auc_and_raises_on_the_rest():
    """Every metric of the oneof is ported now (test_torch_port_metrics.py
    holds each against the JAX package); none raises."""
    cfg = text_format.Parse("auc {}", metric_pb2.MetricConfig())
    made = port_metrics.create_metric(cfg)
    assert made["name"] == "auc" and isinstance(made["metric"],
                                                port_metrics.AUC)
    cfg = text_format.Parse("mean_squared_error {}",
                            metric_pb2.MetricConfig())
    made = port_metrics.create_metric(cfg)
    assert made["name"] == "mean_squared_error" and isinstance(
        made["metric"], port_metrics.MeanSquaredError)


N_TRAIN_STEPS = 40


def _write_parquet(path, cols_list):
    pq.write_table(pa.concat_tables([pa.table(c) for c in cols_list]), path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """40 steps of the small DeepFM in both packages, from the JAX
    package's initial weights and the same batches."""
    tmp = tmp_path_factory.mktemp("deepfm")
    text = deepfm_config_text(BATCH)
    _, jmodel, jfeatures, jstate, jstep = jax_train_setup(text)
    jparser = JaxParser(jfeatures, labels=["label"])
    cfg, model, features, sparse_sched = _port_model(
        text, jmodel, jstate["dense"], jstate["tables"])
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, list(model.parameters()))
    state = port_main._init_state(model)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    parser = DataParser(features, labels=["label"])
    train_cols = [deepfm_cols(BATCH, seed=100 + i)
                  for i in range(N_TRAIN_STEPS)]
    jlosses, losses = [], []
    for cols in train_cols:
        jstate, jm, _ = jstep(jstate, jparser.parse_to_batch(cols),
                              jax.random.key(0))
        jlosses.append(float(jm["total_loss"]))
        state, m = step(state, parser.parse_to_batch(cols))
        losses.append(float(m["total_loss"]))
    eval_cols = deepfm_cols(1000, seed=999)
    eval_path = os.path.join(tmp, "eval.parquet")
    _write_parquet(eval_path, [eval_cols])
    jeval = jax.jit(jax_eval_step(jmodel, jnp.float32, with_loss=False))
    jprobs = np.asarray(jeval(jstate, jparser.parse_to_batch(eval_cols))[0][
        "probs"])
    jauc = jax_metrics._auc(jprobs, eval_cols["label"].to_numpy())
    return dict(jmodel=jmodel, jstate=jstate, jlosses=jlosses, model=model,
                state=state, losses=losses, parser=parser, jauc=jauc,
                eval_path=eval_path, train_cols=train_cols, tmp=tmp,
                cfg=cfg, features=features)


def test_training_losses_track_jax(trained):
    np.testing.assert_allclose(trained["losses"], trained["jlosses"],
                               rtol=2e-3)
    head, tail = np.mean(trained["losses"][:5]), np.mean(
        trained["losses"][-5:])
    assert tail < head  # the labels depend on the features: it learns


def test_eval_auc_within_0_003_of_jax(trained):
    eval_dl = create_dataloader(trained["cfg"].data_config,
                                trained["features"], trained["eval_path"],
                                mode="eval", device="cpu")
    result = port_main._run_eval(
        trained["model"], port_main.make_eval_step(trained["model"]),
        eval_dl)
    assert set(result) == {"auc", "loss_binary_cross_entropy"}
    assert trained["jauc"] > 0.6  # the model ranks better than chance
    assert abs(result["auc"] - trained["jauc"]) <= 0.003
    # num_steps stops the pass early
    short = port_main._run_eval(
        trained["model"], port_main.make_eval_step(trained["model"]),
        eval_dl, num_steps=2)
    assert short["auc"] != result["auc"]


def test_trained_tables_and_row_state_match_jax(trained):
    """After 40 steps the packed tables and their in-row accumulators of
    both packages agree within 1e-3 of each tensor's largest magnitude
    (adam's division amplifies rounding in the dense path, which feeds
    the embedding gradients)."""
    jeng = trained["jmodel"].embedding_group.engine
    eg = trained["model"].embedding_group
    jstate = trained["jstate"]
    for name in TABLES:
        ref = np.asarray(jeng.extract_table(jstate["tables"], name))
        got = eg.engine.extract_table(eg.engine_tables(), name).numpy()
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), name
        jacc = np.asarray(jeng.extract_table_state(
            jstate["tables"], jstate["sparse_opt"], name)["acc"])
        acc = eg.engine.extract_table_state(
            eg.engine_tables(), trained["state"]["sparse_opt"], name)["acc"]
        assert np.abs(acc.numpy() - jacc).max() <= 1e-3 * jacc.max(), name


def _train_and_evaluate(tmp, cols_list, eval_path, **kw):
    model_dir = os.path.join(tmp, "model")
    text = deepfm_config_text(BATCH, model_dir=model_dir, num_steps=3)
    cfg_path = os.path.join(tmp, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    train_path = os.path.join(tmp, "train.parquet")
    _write_parquet(train_path, cols_list)
    result = port_main.train_and_evaluate(
        cfg_path, train_input_path=train_path, eval_input_path=eval_path,
        device="cpu", **kw)
    return text, cfg_path, model_dir, result


def test_train_and_evaluate_returns_eval_metrics(trained, tmp_path):
    text, cfg_path, model_dir, result = _train_and_evaluate(
        str(tmp_path), trained["train_cols"][:3], trained["eval_path"])
    assert result["step"] == 3.0
    assert {"auc", "loss_binary_cross_entropy", "total_loss"} <= set(result)
    assert 0.0 < result["auc"] < 1.0 and np.isfinite(
        result["loss_binary_cross_entropy"])
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        assert '"global_step": 3' in f.read()
    # evaluate() on the checkpoint gives the same numbers
    again = port_main.evaluate(cfg_path, eval_input_path=trained["eval_path"],
                               device="cpu")
    assert again["auc"] == result["auc"]
    assert again["loss_binary_cross_entropy"] == result[
        "loss_binary_cross_entropy"]
    assert os.path.exists(os.path.join(model_dir, "eval_result.txt"))


def test_train_and_evaluate_without_eval_input_skips_eval(trained, tmp_path):
    _, _, _, result = _train_and_evaluate(
        str(tmp_path), trained["train_cols"][:3], None)
    assert result["step"] == 3.0 and "auc" not in result
    with pytest.raises(FileNotFoundError):
        _train_and_evaluate(str(tmp_path), trained["train_cols"][:3],
                            os.path.join(tmp_path, "missing.parquet"))


def test_checkpoint_crosses_between_packed_and_unpacked(trained, tmp_path):
    text, _, model_dir, _ = _train_and_evaluate(
        str(tmp_path), trained["train_cols"][:3], None)
    ckpt = checkpoint_util.latest_checkpoint(model_dir)
    saved = torch.load(ckpt, weights_only=True)
    assert set(saved["sparse_opt"]) == set(TABLES)

    def restored(packed):
        _, model, _, _ = _port_model(text, packed=packed)
        state = checkpoint_util.restore_checkpoint(ckpt, model)
        assert state["step"] == 3
        eg = model.embedding_group
        assert all(g.packed == packed for g in eg.engine.groups.values())
        return model, state

    def assert_holds_checkpoint(model, state):
        eg = model.embedding_group
        for name in TABLES:
            assert torch.equal(eg.tables[name],
                               saved["model"][f"embedding_group.tables.{name}"])
            acc = eg.engine.extract_table_state(
                eg.engine_tables(), state["sparse_opt"], name)["acc"]
            assert torch.equal(acc, saved["sparse_opt"][name]["acc"])
            assert float(acc.max()) > 0

    packed_model, packed_state = restored(True)
    assert_holds_checkpoint(packed_model, packed_state)
    unpacked_model, unpacked_state = restored(False)
    assert_holds_checkpoint(unpacked_model, unpacked_state)
    # the merged WIDE+DEEP group keeps one accumulator per member table
    assert unpacked_state["sparse_opt"]["d12_s8.4"]["acc"].shape[1] == 2
    # and back: the unpacked model's checkpoint into a packed model
    tx, _ = create_dense_optimizer(
        parse_pipeline_config(text).train_config.dense_optimizer,
        list(unpacked_model.parameters()))
    back = checkpoint_util.save_checkpoint(str(tmp_path), unpacked_model, tx,
                                           unpacked_state)
    _, model, _, _ = _port_model(text, packed=True)
    assert_holds_checkpoint(model,
                            checkpoint_util.restore_checkpoint(back, model))
    # both layouts predict the same
    batch = trained["parser"].parse_to_batch(trained["train_cols"][5])
    a = port_main.make_eval_step(packed_model)(batch)[0]["probs"]
    b = port_main.make_eval_step(unpacked_model)(batch)[0]["probs"]
    assert torch.equal(a, b)

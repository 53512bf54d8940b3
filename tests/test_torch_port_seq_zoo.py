"""The sequence layer and the rest of the criteo_synth zoo of the port
against the JAX package (fp32, CPU; one config text and the same Arrow
columns for both; the JAX weights cross through utils/convert.py).

- The five sequence encoders (DIN, SimpleAttention, Pooling,
  SelfAttention, MultiWindowDIN): the forward within rtol 1e-5 /
  atol 1e-6 at sequence lengths 0, 1 and L, with a query narrower than
  the sequence and with ``max_seq_length`` truncation.
- ``EmbeddingGroup`` with a sequence group nested in a DEEP group and two
  encoders on it: keys, dims and values of ``assemble``, and the group
  closure; a SEQUENCE group's own encoders are built on neither side.
- Per model (MultiTower with those encoders, MultiTowerDIN,
  RocketLaunching with and without feature distillation, MMoE with the
  mmoe_has_sequence groups, DBMTL with ``jrc_loss``), from narrowed
  copies of the criteo_synth configs: the forward within rtol 1e-5 /
  atol 1e-6; two train steps (losses, every dense parameter, the tables
  and their row state) within rtol 1e-4 / atol 1e-5, the DeepFM tests'
  tolerance; the eval metrics (names and values) within 1e-12.
- ``jrc_loss`` and ``binary_focal_loss`` within rtol 1e-6.
- ``train_and_evaluate`` of MultiTowerDIN in both packages: the same
  metric names, values within rtol 1e-4.
- The four config copies equal the JAX originals but for their paths,
  each builds at full width with the pinned labels' metric names.

The JAX engine's co-keyed table merge is off and its dense lane takes
the tables of at most ``ZOO_DENSE_LANE`` rows, as the port's; the
shared ``item_emb`` table (200 rows) takes the sorted row write."""

import json
import os

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
    ZOO_SEQ_LEN,
    ZOO_SEQ_MODELS,
    converted_state,
    jax_model_and_state,
    jax_train_setup,
    zoo_cols,
    zoo_config_text,
    zoo_table_names,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu import losses as jax_losses
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules import sequence as jax_sequence
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch import losses
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules import sequence
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    create_dense_optimizer,
)
from torcheasyrec_tpu_torch.protos import pipeline_pb2 as port_pb2
from torcheasyrec_tpu_torch.utils import convert
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-6, atol=0)
BATCH = 64
LABELS = ["label", "conversion"]
N_STEPS = 2
EVAL_ROWS = 1000
CLASSES = {
    "multi_tower": "MultiTower", "multi_tower_din": "MultiTowerDIN",
    "rocket_launching": "RocketLaunching",
    "rocket_launching_logits": "RocketLaunching",
    "mmoe_has_sequence": "MMoE", "dbmtl_jrc": "DBMTL",
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = os.path.join(REPO, "torcheasyrec_tpu_torch", "benchmark",
                            "configs")
JAX_CONFIGS = os.path.join(REPO, "torcheasyrec_tpu", "benchmark", "configs")
CONFIG_COPIES = {"multi_tower_din": "MultiTowerDIN",
                 "mmoe_has_sequence": "MMoE",
                 "rocket_launching": "RocketLaunching", "dbmtl_jrc": "DBMTL"}


@pytest.fixture(scope="module")
def jax_engine_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TZREC_DENSE_LANE", str(ZOO_DENSE_LANE))
        mp.setenv("TZREC_PACKED", "1")
        yield


def _port_model(text):
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, dense_lane_rows=ZOO_DENSE_LANE)
    return cfg, model, features, sparse_sched


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- the sequence encoders -----------------------------------------------

B, L, DS = 6, 5, 8
LENGTHS = np.array([0, 1, L, 3, 2, 4], np.int32)  # 0, 1 and L among them
MLP = {"hidden_units": [12, 6]}
ENCODER_CASES = {
    # name: (class, kwargs, query width)
    "din_narrow_query": ("DINEncoder", dict(attn_mlp=MLP), 5),
    "din_max_seq_length": ("DINEncoder",
                           dict(attn_mlp=MLP, max_seq_length=3), DS),
    "simple_attention": ("SimpleAttention", dict(max_seq_length=4), DS),
    "pooling_sum": ("PoolingEncoder", dict(pooling_type="sum"), DS),
    "pooling_mean_max_seq_length": (
        "PoolingEncoder", dict(pooling_type="mean", max_seq_length=2), DS),
    "self_attention": ("SelfAttentionEncoder",
                       dict(multihead_attn_dim=12, num_heads=3,
                            max_seq_length=4), DS),
    # the last window runs past the sequence: a zero block
    "multi_window_din": ("MultiWindowDINEncoder",
                         dict(attn_mlp=MLP, windows_len=[2, 2, 3]), 5),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_sequence_encoder_matches_jax(case):
    cls, kw, dq = ENCODER_CASES[case]
    common = dict(sequence_dim=DS, query_dim=dq, input="s")
    jenc = getattr(jax_sequence, cls)(**common, **kw)
    params = jenc.init(jax.random.key(3))
    # nonzero biases, so a bias rule that went wrong shows
    params = jax.tree_util.tree_map(lambda a: a + 0.05, params)
    enc = getattr(sequence, cls)(**common, **kw, generator=torch.Generator())
    enc.load_state_dict(convert.from_jax_state(jax.device_get(params), {}),
                        strict=True)
    group = {"s.query": _x(B, dq, seed=1), "s.sequence": _x(B, L, DS, seed=2),
             "s.sequence_length": LENGTHS}
    ref = np.asarray(jenc(params, {k: jnp.asarray(v) for k, v in
                                   group.items()}, JM.eval_ctx()))
    got = enc.eval()({k: torch.from_numpy(v) for k, v in group.items()},
                     torch.float32)
    assert got.shape == ref.shape == (B, enc.output_dim())
    assert enc.output_dim() == jenc.output_dim()
    np.testing.assert_allclose(got.detach().numpy(), ref, **FWD_TOL)


def test_din_with_no_history_attends_uniformly():
    """Length 0: every position is masked alike, the softmax is uniform,
    as in the JAX package; a history of padding rows then gives 0."""
    enc = sequence.DINEncoder(DS, DS, "s", MLP, torch.Generator())
    seq = torch.zeros(2, L, DS)
    seq[1, :2] = 1.0
    out = enc({"s.query": torch.ones(2, DS), "s.sequence": seq,
               "s.sequence_length": torch.tensor([0, 2])}, torch.float32)
    assert torch.equal(out[0], torch.zeros(DS))
    np.testing.assert_allclose(out[1].detach().numpy(), np.ones(DS),
                               rtol=1e-6)


# --- the embedding group --------------------------------------------------


def _groups_case(model_key):
    text = zoo_config_text(model_key, BATCH)
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(text)
    _, model, features, _ = _port_model(text)
    model.load_state_dict(converted_state(jmodel, dense, tables,
                                          zoo_table_names(model_key)))
    return jmodel, jfeatures, dense, tables, model, features


def test_assemble_with_a_nested_sequence_group_and_encoders_matches_jax(
        jax_engine_env):
    jmodel, jfeatures, dense, tables, model, features = _groups_case(
        "multi_tower")
    jeg, eg = jmodel.embedding_group, model.embedding_group
    assert eg.group_names() == jeg.group_names() == ["user", "item"]
    for g in ("user", "item"):
        assert eg.group_dims(g) == jeg.group_dims(g), g
    # 3 id features of 8, then DIN (8) and sum pooling (8)
    assert eg.group_dims("user") == [8] * 5
    assert eg.seq_group_dims() == jeg.seq_group_dims() == {
        "hist.query": 8, "hist.sequence": 8}
    assert eg.groups_closure(["user", "item"]) == jeg.groups_closure(
        ["user", "item"]) == ["user", "item", "hist"]
    assert sorted(k for k in model.state_dict()
                  if k.startswith("embedding_group.encoders.")) == sorted(
        f"embedding_group.encoders.user.0.{k}" for k in (
            "mlp.layers.0.linear.weight", "mlp.layers.0.linear.bias",
            "mlp.layers.1.linear.weight", "mlp.layers.1.linear.bias",
            "linear.weight", "linear.bias"))

    cols = zoo_cols(BATCH, seed=5)
    jbatch = JaxParser(jfeatures, labels=LABELS).parse_to_batch(cols)
    batch = DataParser(features, labels=LABELS).parse_to_batch(cols)
    ref, _ = jeg.forward(tables, jbatch, dense["embedding_group"],
                         JM.eval_ctx())
    with torch.no_grad():
        got = eg(batch, torch.float32)
    assert set(got) == set(ref) == {
        "user", "item", "hist.query", "hist.sequence",
        "hist.sequence_length"}
    assert tuple(got["hist.sequence"].shape) == (BATCH, ZOO_SEQ_LEN, 8)
    lengths = got["hist.sequence_length"].numpy()
    assert lengths.min() == 0 and lengths.max() == ZOO_SEQ_LEN
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **FWD_TOL)


def test_sequence_group_encoders_are_built_on_neither_side(jax_engine_env):
    """mmoe_has_sequence hangs a DIN encoder on its SEQUENCE group; the
    JAX package never builds it, so neither does the port."""
    jmodel, _, dense, _, model, _ = _groups_case("mmoe_has_sequence")
    assert jmodel.embedding_group._group_encoders == {}
    assert jax.tree_util.tree_leaves(dense["embedding_group"]) == []
    assert len(model.embedding_group.encoders) == 0
    assert not [k for k in model.state_dict()
                if k.startswith("embedding_group.encoders")]
    assert model.embedding_group.group_names() == ["all"]
    assert model.embedding_group.has_group("seq")


# --- the models ------------------------------------------------------------


def _as_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(ZOO_SEQ_MODELS))
def seq_run(request, jax_engine_env):
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
    preds, losses_ = port_main.make_eval_step(model)(batch)

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
                jlosses=jlosses, losses=losses_, jstate=jstate, state=state,
                jstep_losses=jstep_losses, step_losses=step_losses,
                tables=tables)


def test_seq_zoo_model_builds_from_config_text(seq_run):
    model, jmodel = seq_run["model"], seq_run["jmodel"]
    assert isinstance(model, BaseModel)
    assert type(model).__name__ == type(jmodel).__name__ == CLASSES[
        seq_run["key"]]
    eg, jeg = model.embedding_group, jmodel.embedding_group
    assert eg.group_names() == jeg.group_names()
    for g in eg.group_names():
        assert eg.group_dims(g) == jeg.group_dims(g), g
    assert set(eg.tables) == set(seq_run["tables"])
    assert all(g.packed for g in eg.engine.groups.values())


def test_seq_zoo_forward_matches_jax(seq_run):
    preds, jpreds = seq_run["preds"], seq_run["jpreds"]
    assert set(preds) == set(jpreds)
    assert any(k.startswith("probs") for k in preds)
    for k, v in preds.items():
        assert v.dtype == torch.float32, k
        assert tuple(v.shape) == jpreds[k].shape and v.shape[0] == BATCH, k
        np.testing.assert_allclose(v.numpy(), jpreds[k], err_msg=k,
                                   **FWD_TOL)
    losses_, jlosses = seq_run["losses"], seq_run["jlosses"]
    assert set(losses_) == set(jlosses)
    for k in losses_:
        np.testing.assert_allclose(float(losses_[k]), float(jlosses[k]),
                                   err_msg=k, **FWD_TOL)


def test_seq_zoo_two_train_steps_match_jax(seq_run):
    for ours, ref in zip(seq_run["step_losses"], seq_run["jstep_losses"]):
        assert set(ours) == set(ref)
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    model, jstate = seq_run["model"], seq_run["jstate"]
    jdense = convert.from_jax_state(jax.device_get(jstate["dense"]), {})
    params = dict(model.named_parameters())
    assert set(params) == set(jdense)
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), jdense[n].numpy(),
                                   err_msg=n, **TOL)
    jeng = seq_run["jmodel"].embedding_group.engine
    eg = model.embedding_group
    fused = eg.engine_tables()
    for name in seq_run["tables"]:
        ref = np.asarray(jeng.extract_table(jstate["tables"], name))
        got = eg.engine.extract_table(fused, name).numpy()
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)
        jacc = np.asarray(jeng.extract_table_state(
            jstate["tables"], jstate["sparse_opt"], name)["acc"])
        acc = eg.engine.extract_table_state(
            fused, seq_run["state"]["sparse_opt"], name)["acc"]
        np.testing.assert_allclose(acc.numpy(), jacc, err_msg=name, **TOL)
    if "item_emb" in seq_run["tables"]:
        # the history's rows trained, except where the model ignores them
        jacc = np.asarray(jeng.extract_table_state(
            jstate["tables"], jstate["sparse_opt"], "item_emb")["acc"])
        assert (float(np.abs(jacc).max()) > 0) == (
            seq_run["key"] != "mmoe_has_sequence")


def test_seq_zoo_metrics_match_jax(seq_run):
    """The eval metrics of both packages on the JAX predictions: the same
    names (RocketLaunching's ``auc_light``, per tower ``<metric>_<tower>``)
    and the same values."""
    model, jmodel = seq_run["model"], seq_run["jmodel"]
    jpreds = seq_run["jpreds"]
    ours, ref = model.init_metrics(), jmodel.init_metrics()
    for _ in range(2):
        model.update_metrics(
            ours, {k: torch.from_numpy(v.copy()) for k, v in jpreds.items()},
            seq_run["batch"])
        jmodel.update_metrics(ref, jpreds, jax.device_get(seq_run["jbatch"]))
    got, want = model.compute_metrics(ours), jmodel.compute_metrics(ref)
    assert list(got) == list(want)
    if seq_run["key"].startswith("rocket"):
        assert list(got) == ["auc_light", "grouped_auc_cat_1"]
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


# --- the losses ------------------------------------------------------------


def _session_case(case, r, n=257):
    if case == "all_distinct":
        return np.arange(n), r.random(n) < 0.4
    if case == "one_session":
        return np.zeros(n, np.int64), r.random(n) < 0.3
    if case == "one_class_sessions":
        sess = r.integers(0, 9, n)
        labels = (r.random(n) < 0.5) & (sess % 3 != 0)  # 1/3 negatives only
        return sess, labels | (sess == 4)  # and one session of positives
    if case == "zipf_sessions":
        return (np.minimum((r.random(n) ** 2.5 * 40).astype(np.int64), 39),
                r.random(n) < 0.2)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["all_distinct", "one_session",
                                  "one_class_sessions", "zipf_sessions"])
def test_jrc_loss_matches_jax(case):
    r = np.random.default_rng(11)
    sess, labels = _session_case(case, r)
    logits = (r.normal(size=(len(sess), 2)) * 2).astype(np.float32)
    labels = labels.astype(np.float32)
    for alpha in (0.5, 0.2):
        ref = np.asarray(jax_losses.jrc_loss(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(sess),
            alpha))
        got = losses.jrc_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(sess), alpha)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **LOSS_TOL)


def test_jrc_loss_gradient_is_finite():
    """-inf outside the session mask: the log-softmax's backward stays
    finite, and a sample alone in its session still gets its CE part."""
    r = np.random.default_rng(12)
    logits = torch.from_numpy(r.normal(size=(40, 2)).astype(np.float32))
    logits.requires_grad_(True)
    labels = torch.from_numpy((r.random(40) < 0.5).astype(np.float32))
    losses.jrc_loss(logits, labels, torch.arange(40) % 7).mean().backward()
    assert torch.isfinite(logits.grad).all()
    assert (logits.grad.abs().sum(dim=1) > 0).all()


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.5), (0.0, 0.25), (3.5, 0.9)])
def test_binary_focal_loss_matches_jax(gamma, alpha):
    r = np.random.default_rng(13)
    logits = (r.normal(size=300) * 3).astype(np.float32)
    labels = (r.random(300) < 0.3).astype(np.float32)
    ref = np.asarray(jax_losses.binary_focal_loss(
        jnp.asarray(logits), jnp.asarray(labels), gamma, alpha))
    got = losses.binary_focal_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), gamma, alpha)
    np.testing.assert_allclose(got.numpy(), ref, **LOSS_TOL)


def _grouping_batches(case):
    """(port Batch, JAX Batch) holding one grouping column ``k``."""
    from torcheasyrec_tpu.datasets import utils as jax_utils
    from torcheasyrec_tpu_torch.datasets import utils as port_utils

    r = np.random.default_rng(14)
    if case == "label":
        v = (r.random(9) < 0.5).astype(np.float32)
        return (port_utils.Batch(labels={"k": torch.from_numpy(v)}),
                jax_utils.Batch(labels={"k": jnp.asarray(v)}))
    if case == "dense":
        v = r.normal(size=(9, 2)).astype(np.float32)
        return (port_utils.Batch(dense_features={
                    "k": port_utils.DenseField(torch.from_numpy(v))}),
                jax_utils.Batch(dense_features={
                    "k": jax_utils.DenseField(jnp.asarray(v))}))
    if case == "fixed":
        vals, lengths = r.integers(0, 50, (9, 2)).astype(np.int32), None
    else:  # jagged, with empty rows and the padding past the last id
        lengths = np.array([2, 0, 1, 3, 0, 1, 1, 2, 0], np.int32)
        vals = np.full(16, -1, np.int32)
        vals[:lengths.sum()] = r.integers(0, 50, lengths.sum())
    lt = None if lengths is None else torch.from_numpy(lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    return (port_utils.Batch(sparse_features={
                "k": port_utils.SparseField(torch.from_numpy(vals), lt)}),
            jax_utils.Batch(sparse_features={
                "k": jax_utils.SparseField(jnp.asarray(vals), lj)}))


@pytest.mark.parametrize("case", ["label", "dense", "fixed", "jagged"])
def test_session_ids_match_jax(case):
    """JRC's session column: a label, the first value of a dense feature,
    the first id of a sparse one (-1 for a jagged row without ids)."""
    from torcheasyrec_tpu.models.rank_model import (
        _grouping_value_dev as jax_grouping,
    )
    from torcheasyrec_tpu_torch.models.rank_model import _grouping_value_dev

    batch, jbatch = _grouping_batches(case)
    got = _grouping_value_dev(batch, "k").numpy()
    ref = np.asarray(jax_grouping(jbatch, "k"))
    assert got.shape == ref.shape == (9,)
    np.testing.assert_array_equal(got, ref)
    if case == "jagged":
        assert (got[[1, 4, 8]] == -1).all()


@pytest.mark.parametrize("where", ["rank", "multi_task"])
def test_jrc_loss_needs_two_classes(where):
    """A one-class JRC head raises in the port; a multi-task one raises in
    both packages."""
    if where == "rank":
        text = zoo_config_text("multi_tower_din").replace(
            "losses { binary_cross_entropy {} }",
            'losses { jrc_loss { session_name: "cat_2" } }')
    else:
        text = zoo_config_text("dbmtl_jrc").replace("    num_class: 2\n", "")
        with pytest.raises(ValueError, match="num_class >= 2"):
            jax_model_and_state(text)
    with pytest.raises(ValueError, match="num_class >= 2"):
        _port_model(text)


# --- the entry points -------------------------------------------------------


@pytest.fixture(scope="module")
def seq_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_zoo")
    for i, n in enumerate((100, 92)):
        pq.write_table(pa.table(zoo_cols(n, seed=50 + i)),
                       os.path.join(root, f"train-{i}.parquet"))
    pq.write_table(pa.table(zoo_cols(EVAL_ROWS, seed=60)),
                   os.path.join(root, "eval.parquet"))
    return str(root)


def _seq_config(path, model, model_dir, root):
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


def test_train_and_evaluate_multi_tower_din_matches_jax(
        seq_files, tmp_path, monkeypatch, jax_engine_env):
    """5 steps of 32 over two files, a save and an eval at step 3 and at
    the end, in both packages from the JAX init."""
    model = "multi_tower_din"
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_dir = str(tmp_path / "jax")
    jax_cfg, text = _seq_config(str(tmp_path / "jax.config"), model, jax_dir,
                                seq_files)
    jax_main.train_and_evaluate(jax_cfg)

    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = str(tmp_path / "jax_init.pt")
    torch.save(converted_state(jmodel, dense, tables,
                               zoo_table_names(model)), init)
    port_dir = str(tmp_path / "port")
    port_cfg, _ = _seq_config(str(tmp_path / "port.config"), model, port_dir,
                              seq_files)
    result = port_main.train_and_evaluate(port_cfg, fine_tune_checkpoint=init,
                                          device="cpu")
    assert result["step"] == 5.0
    ours, ref = _eval_lines(port_dir), _eval_lines(jax_dir)
    assert [r["global_step"] for r in ours] == [
        r["global_step"] for r in ref] == [3, 5]
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        assert "auc" in a and "grouped_auc_cat_1" in a
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)


# --- the configs ------------------------------------------------------------


def _without_paths(text, pb2):
    cfg = text_format.Parse(text, pb2.EasyRecConfig())
    for field in ("train_input_path", "eval_input_path", "model_dir"):
        cfg.ClearField(field)
    return cfg.SerializePartialToString(deterministic=True)


@pytest.mark.parametrize("name", sorted(CONFIG_COPIES))
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
    pinned = labels[f"torcheasyrec_tpu_torch/benchmark/configs/{key}"]
    assert pinned == jax_labels[f"torcheasyrec_tpu/benchmark/configs/{key}"]
    # the full-width model builds, and reports the pinned metrics
    model, _ = port_main.build_model(cfg, "cpu")
    assert type(model).__name__ == CONFIG_COPIES[name]
    assert [m["name"] for m in model.init_metrics()] == list(
        pinned["metrics"])
    eg = model.embedding_group
    assert [d for d in eg.group_dims("all")] == [16] * (
        18 if "seq" in eg._seq_groups else 26) + [1] * 13
    if eg.has_group("seq"):
        assert eg.seq_group_dims() == {"seq.query": 16, "seq.sequence": 16}
        assert eg.engine._specs["item_emb"].rows == 2000

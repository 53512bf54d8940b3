"""DLRM-HSTU training, end to end: the port's train step against the JAX
package's ``make_train_step`` from one config text, the same Arrow
columns and the JAX weights carried across by utils/convert.py (fp32,
CPU, all dropout ratios 0).

Tolerances: losses rtol 1e-4; dense parameters, tables and the row-wise
accumulator within 1e-3 of each tensor's largest magnitude (adam divides
by the root of the second moment, which amplifies rounding in small
gradients). Both engines pack these narrow tables (slot 33 and 65)."""

import os

import jax
import numpy as np
import optax
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import (
    hstu_synth_train_config_text,
    jax_train_setup,
    synth_cols,
)
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.modules import module as port_module
from torcheasyrec_tpu_torch.ops import hstu as port_hstu
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    create_dense_optimizer,
)
from torcheasyrec_tpu_torch.utils import checkpoint_util, convert
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

BATCH = 4
N_STEPS = 3
TABLES = ("user_id_emb", "video_id_emb")


def _jax_snapshot(jmodel, state, metrics):
    """Everything of the JAX train state the port is compared with, as
    numpy, under the port's names."""
    eng = jmodel.embedding_group.engine
    tables = {n: np.asarray(eng.extract_table(state["tables"], n))
              for n in TABLES}
    table_states = {
        n: {k: np.asarray(v) for k, v in eng.extract_table_state(
            state["tables"], state["sparse_opt"], n).items()}
        for n in TABLES
    }
    adam = [s for s in jax.tree_util.tree_leaves(
        state["dense_opt"],
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return {
        "model": convert.from_jax_state(jax.device_get(state["dense"]),
                                        tables),
        "table_states": table_states,
        "adam": jax.device_get((adam.mu, adam.nu, adam.count)),
        "metrics": {k: float(v) for k, v in metrics.items()
                    if not k.startswith("__")},
    }


def _port_trainer(text, snapshot=None):
    """(model, tx, state, train_step) of the port on the CPU, with the
    weights (and, if given, the optimizer state) of a JAX snapshot."""
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True)
    named = [(n, p) for n, p in model.named_parameters()]
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, [p for _, p in named])
    state = port_main._init_state(model)
    if snapshot is not None:
        model.load_state_dict(snapshot["model"])
        if "table_states" in snapshot:
            state["sparse_opt"] = convert.sparse_opt_state_from_jax(
                model.embedding_group.engine, snapshot["table_states"],
                model.embedding_group.engine_tables())
            tx.load_state_dict(convert.dense_opt_state_from_jax(
                *snapshot["adam"], [n for n, _ in named]))
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    return model, features, tx, state, step


def _assert_close_rel(got, ref, name, tol=1e-3):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _assert_matches_snapshot(model, state, metrics, snap):
    for k, v in snap["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                   err_msg=k)
    sd = model.state_dict()
    assert set(sd) == set(snap["model"])
    for name, ref in snap["model"].items():
        _assert_close_rel(sd[name].numpy(), ref.numpy(), name)
    eng = model.embedding_group.engine
    for t in TABLES:
        got = eng.extract_table_state(
            model.embedding_group.engine_tables(), state["sparse_opt"], t)
        assert set(got) == set(snap["table_states"][t])
        for k, ref in snap["table_states"][t].items():
            _assert_close_rel(got[k].numpy().reshape(ref.shape), ref,
                              f"{t}.{k}")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's state at step 0 and after each of N_STEPS steps
    on N_STEPS different batches."""
    text = hstu_synth_train_config_text(BATCH)
    _, jmodel, jfeatures, state, step = jax_train_setup(text)
    parser = JaxParser(jfeatures, labels=["unused_label"])
    cols = [synth_cols(BATCH, seed=10 + i) for i in range(N_STEPS)]
    snaps = [_jax_snapshot(jmodel, state, {})]
    del snaps[0]["table_states"]  # step 0: the port's own init state
    for c in cols:
        state, metrics, _ = step(state, parser.parse_to_batch(c),
                                 jax.random.key(0))
        snaps.append(_jax_snapshot(jmodel, state, metrics))
    return text, cols, snaps


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_train_steps_match_jax(jax_run, n_steps):
    text, cols, snaps = jax_run
    model, features, _, state, step = _port_trainer(text, snaps[0])
    parser = DataParser(features, labels=["unused_label"])
    launches = (port_hstu.hstu_attention_fwd.launches,
                port_hstu.hstu_attention_bwd.launches)
    for i in range(n_steps):
        state, metrics = step(state, parser.parse_to_batch(cols[i]))
        if i == 0:
            _assert_matches_snapshot(model, state, metrics, snaps[1])
    assert state["step"] == n_steps
    _assert_matches_snapshot(model, state, metrics, snaps[n_steps])
    # CPU tensors take the plain versions: no kernel was launched
    assert launches == (port_hstu.hstu_attention_fwd.launches,
                        port_hstu.hstu_attention_bwd.launches)


def test_optimizer_state_carried_at_step_1(jax_run):
    """convert carries the sparse and dense optimizer state: a port
    trainer started from the JAX state after step 1 lands on the JAX
    state after step 3."""
    text, cols, snaps = jax_run
    model, features, tx, state, step = _port_trainer(text, snaps[1])
    state["step"] = 1
    assert tx.count == 1
    parser = DataParser(features, labels=["unused_label"])
    for c in cols[1:]:
        state, metrics = step(state, parser.parse_to_batch(c))
    _assert_matches_snapshot(model, state, metrics, snaps[N_STEPS])


def test_untouched_rows_keep_their_bits(jax_run):
    text, cols, snaps = jax_run
    model, features, _, state, step = _port_trainer(text, snaps[0])
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "tables." in k}
    batch = DataParser(features, labels=["unused_label"]).parse_to_batch(
        cols[0])
    state, _ = step(state, batch)
    ids = torch.cat([
        batch.sequence_sparse_features["video_id"].values.reshape(-1),
        batch.sequence_sparse_features["item_video_id"].values.reshape(-1),
    ])
    touched = torch.zeros(before["embedding_group.tables.video_id_emb"]
                          .shape[0], dtype=torch.bool)
    touched[ids[ids >= 0].long()] = True
    after = model.state_dict()["embedding_group.tables.video_id_emb"]
    same = (after == before["embedding_group.tables.video_id_emb"]).all(dim=1)
    assert same[~touched].all()
    assert not same[touched].any()
    acc = model.embedding_group.engine.extract_table_state(
        model.embedding_group.engine_tables(), state["sparse_opt"],
        "video_id_emb")["acc"][:, 0]
    assert (acc[~touched] == 0).all() and (acc[touched] > 0).all()


@pytest.mark.parametrize("uvqk,y", [(True, True), (True, False),
                                    (False, True)])
def test_recompute_settings_agree(jax_run, uvqk, y):
    """recompute_uvqk / recompute_y rematerialize stages in the backward;
    the gradients, so the parameters after a step, do not change."""
    _, cols, snaps = jax_run

    def run(stu_extra):
        text = hstu_synth_train_config_text(BATCH, stu_extra=stu_extra)
        model, features, _, state, step = _port_trainer(text, snaps[0])
        _, metrics = step(state, DataParser(
            features, labels=["unused_label"]).parse_to_batch(cols[0]))
        return model.state_dict(), metrics

    ref_sd, ref_m = run("recompute_uvqk: false\nrecompute_y: false")
    sd, m = run(f"recompute_uvqk: {str(uvqk).lower()}\n"
                f"recompute_y: {str(y).lower()}")
    assert float(m["total_loss"]) == float(ref_m["total_loss"])
    for k in ref_sd:
        np.testing.assert_allclose(sd[k].numpy(), ref_sd[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_recompute_with_dropout_sees_the_same_mask():
    """With output dropout on, a rematerialized output stage must see the
    mask of the forward: recompute on and off give the same step."""
    def run(recompute):
        text = hstu_synth_train_config_text(
            BATCH, input_dropout=0.2, stu_extra=(
                "output_dropout_ratio: 0.3\n"
                f"recompute_uvqk: {recompute}\nrecompute_y: {recompute}"))
        model, features, _, state, step = _port_trainer(text)
        cols = synth_cols(BATCH, seed=5)
        _, metrics = step(state, DataParser(
            features, labels=["unused_label"]).parse_to_batch(cols))
        return model.state_dict(), float(metrics["total_loss"])

    sd_a, loss_a = run("true")
    sd_b, loss_b = run("false")
    assert loss_a == loss_b
    for k in sd_a:
        np.testing.assert_allclose(sd_a[k].numpy(), sd_b[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_is_seeded_and_keeps_one_minus_p(p):
    x = torch.ones(200, 500)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        outs.append(port_module.dropout(x, p, True, g))
    assert torch.equal(outs[0], outs[1])
    other = port_module.dropout(x, p, True, torch.Generator().manual_seed(4))
    assert not torch.equal(outs[0], other)
    kept = (outs[0] != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 0.01
    np.testing.assert_allclose(outs[0][outs[0] != 0].numpy(), 1 / (1 - p),
                               rtol=1e-6)
    # the identity in eval and at p = 0
    assert port_module.dropout(x, p, False, None) is x
    assert port_module.dropout(x, 0.0, True, None) is x


def test_training_mode_dropout_changes_the_forward():
    text = hstu_synth_train_config_text(BATCH, input_dropout=0.2)
    model, features, _, _, _ = _port_trainer(text)
    batch = DataParser(features, labels=["unused_label"]).parse_to_batch(
        synth_cols(BATCH, seed=6))
    with torch.no_grad():
        a = model.train()(batch)["logits_is_click"]
        b = model.train()(batch)["logits_is_click"]
        c = model.eval()(batch)["logits_is_click"]
        d = model.eval()(batch)["logits_is_click"]
    assert not torch.equal(a, b)  # two masks from one generator
    assert torch.equal(c, d)


def test_unported_training_options_raise():
    """Accumulation and the grad scaler are ported now
    (test_torch_port_train_options.py holds them against the JAX
    package): the steps build, and a scaler outside FP16 is ignored, as
    in the JAX package. So does variational dropout (held against the JAX
    package in tests/test_torch_port_zoo_rest.py): DLRM-HSTU's one
    non-sequence group has a single feature, so it gates nothing, as in
    the JAX package. fg_mode FG_NORMAL still raises."""
    text = hstu_synth_train_config_text(BATCH)
    model, _, tx, _, _ = _port_trainer(text)
    sched = {"fn": lambda *a: 1.0, "by_epoch": False}
    port_main.make_train_step(model, tx, sched, sched, grad_accum_steps=2)
    port_main.make_train_step(model, tx, sched, sched,
                              grad_scaler_cfg=object())
    assert "scaler" not in port_main._init_state(model, tx, 1, object())
    vd_model = _port_trainer(text.replace(
        "model_config {", "model_config {\n  variational_dropout {}", 1))[0]
    assert vd_model._base_model_config.HasField("variational_dropout")
    assert not vd_model.variational_dropout
    with pytest.raises(NotImplementedError, match="FG_NONE"):
        _port_trainer(text.replace("fg_mode: FG_NONE", "fg_mode: FG_NORMAL"))


def test_train_and_evaluate_checkpoint_round_trip(tmp_path):
    """train_and_evaluate on the CPU writes a checkpoint that
    predict_checkpoint loads and that reproduces the in-memory model."""
    text = hstu_synth_train_config_text(BATCH, input_dropout=0.2)
    text = text.replace("/tmp/tzrec_bench_model/dlrm_hstu",
                        str(tmp_path / "model"))
    text = text.replace("num_epochs: 2", "num_steps: 2")
    cfg_path = os.path.join(tmp_path, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    # 2 full batches and a remainder the trainer drops
    cols = synth_cols(2 * BATCH + 1, seed=8)
    inp = os.path.join(tmp_path, "train.parquet")
    pq.write_table(pa.table(cols), inp)
    result = port_main.train_and_evaluate(cfg_path, train_input_path=inp,
                                          device="cpu")
    assert result["step"] == 2.0 and np.isfinite(result["total_loss"])
    ckpt = checkpoint_util.latest_checkpoint(str(tmp_path / "model"))
    assert ckpt.endswith("model.ckpt-2.pt")
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 2 and saved["dense_opt"]["count"] == 2
    # the sparse optimizer state is saved per table, whatever the layout
    assert set(saved["sparse_opt"]) == set(TABLES)
    assert saved["sparse_opt"]["video_id_emb"]["acc"].shape == (5000, 1)

    # the same two steps in memory
    model, features, _, state, step = _port_trainer(text)
    parser = DataParser(features, labels=["unused_label"])
    table = pa.table(cols)
    for i in range(2):
        chunk = table.slice(i * BATCH, BATCH)
        state, _ = step(state, parser.parse_to_batch(
            {n: chunk.column(n).combine_chunks() for n in chunk.column_names}))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k

    out = os.path.join(tmp_path, "out.parquet")
    n = port_main.predict_checkpoint(cfg_path, inp, out, device="cpu")
    assert n == 2 * BATCH + 1
    written = pq.read_table(out)
    with torch.no_grad():
        preds = model.eval()(DataParser(features).parse_to_batch(cols))
    for key in ("probs_is_click", "probs_is_like"):
        got = np.stack(written[key].to_numpy(zero_copy_only=False))
        np.testing.assert_allclose(got, preds[key].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)

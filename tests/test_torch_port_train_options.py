"""The training loop's options of the port against the JAX package (CPU,
one config text, the same Arrow columns, the JAX weights carried across
by utils/convert.py): gradient clipping, per-part dense optimizers, the
FP16 grad scaler, gradient accumulation and its resume, FP16 DLRM-HSTU,
``steps_per_dispatch``, train metrics and ``is_profiling``.

Tolerances, relative to each tensor's largest magnitude:
- fp32: dense parameters 1e-4 (adam divides by the root of the second
  moment), tables and row state 1e-5, as in test_torch_port_sparse_kinds.
- FP16 compute: the forward and backward round to fp16 (11 bits) at
  other places in the two libraries (the port's fp16 products round
  before the bias is added, XLA's once after it), so the fp16 tolerance
  of the attention kernels, 5e-3, holds the losses (relative), the dense
  parameters and the tables; the row state within 2e-2 (sums of squares
  of fp16-noisy gradients). The dense optimizer there is sgd: adam
  normalises each gradient element, so an element at fp16's rounding
  level may step by lr either way in the two libraries.
- The scaler's scale and good-step count, and which steps it skips, are
  equal; a skipped step leaves the dense parameters and the tables bit
  for bit as they were, in both packages."""

import json
import logging
import os
import re

import jax
import numpy as np
import optax
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import (
    PairedTrainers,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    hstu_synth_train_config_text,
    jax_model_and_state,
    jax_options_setup,
    port_options_setup,
    synth_cols,
)
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.optim import optimizer_builder as jax_builder
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.utils import checkpoint_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config
from torcheasyrec_tpu_torch.utils.convert import (
    dense_param_paths,
    from_jax_state,
)

BATCH = 64
TABLES = deepfm_table_names()
HSTU_TABLES = ("user_id_emb", "video_id_emb")


def _adam_count(jstate) -> int:
    """The step count of the JAX state's (first) adam."""
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate["dense_opt"],
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count)


# --- per-part dense optimizers and clipping ---------------------------------

PART_CASES = {
    # a part with a schedule of its own, one inheriting the main one
    "own_schedule": (
        "adam_optimizer { lr: 0.01 } constant_learning_rate {}\n"
        '  part_optimizers { sgd_optimizer { lr: 0.1 }'
        ' regex_pattern: "deep_mlp/.*"'
        " exponential_decay_learning_rate { decay_size: 1"
        " decay_factor: 0.5 } }\n"
        '  part_optimizers { adagrad_optimizer { lr: 0.05 }'
        ' regex_pattern: "output/.*" }'),
    # tests/test_part_optimizers.py:78: "deep_mlp" fully matches no path,
    # so the second part owns the deep MLP
    "first_full_match": (
        "sgd_optimizer { lr: 0.01 } constant_learning_rate {}\n"
        '  part_optimizers { sgd_optimizer { lr: 0.1 } regex_pattern:'
        ' "deep_mlp" constant_learning_rate {} }\n'
        '  part_optimizers { adam_optimizer { lr: 0.02 } regex_pattern:'
        ' "deep_mlp/.*" manual_step_learning_rate { schedule_sizes: 2'
        " learning_rates: 0.0 } }\n"
        '  part_optimizers { rmsprop_optimizer { lr: 0.01 } regex_pattern:'
        ' "(deep|final)_mlp/layer_0/.*" }'),
    "no_part_schedule": (
        "adam_optimizer { lr: 0.01 }"
        " exponential_decay_learning_rate { decay_size: 1 decay_factor: 0.7 }"
        '\n  part_optimizers { adamw_optimizer { lr: 0.003'
        ' weight_decay: 0.1 } regex_pattern: "final_mlp/.*kernel" }'),
}
CLIP_CASES = {"none": "", "norm": 'clipping_type: "norm" max_gradient: 0.05',
              "value": 'clipping_type: "value" max_gradient: 0.001'}


@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_part_optimizers_select_the_same_parameters(case):
    text = deepfm_config_text(BATCH, dense_opt=PART_CASES[case])
    cfg, _, _, dense, _ = jax_model_and_state(text)
    jpaths = jax_builder._param_paths(dense)
    patterns = [re.compile(p.regex_pattern) for p in
                cfg.train_config.dense_optimizer.part_optimizers]
    jowner = {p: jax_builder._owner_index(p, patterns) for p in jpaths}
    model, _, _ = port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu")
    tx, _ = port_main._dense_optimizer(
        model, parse_pipeline_config(text).train_config)
    paths = dense_param_paths(model)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    owner = {paths[n]: o for n, o in zip(names, tx.owner)}
    assert owner == jowner
    # every part owns parameters, but the "deep_mlp" that fully matches
    # none of them
    unused = {1} if case == "first_full_match" else set()
    assert set(owner.values()) == set(range(len(patterns) + 1)) - unused


@pytest.mark.parametrize("clip", sorted(CLIP_CASES))
@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_parts_and_clipping_three_steps_match_jax(case, clip):
    extra = f"  grad_clipping {{ {CLIP_CASES[clip]} }}" if clip != "none" \
        else ""
    text = deepfm_config_text(BATCH, dense_opt=PART_CASES[case],
                              train_extra=extra)
    pair = PairedTrainers(text, TABLES, ["label"])
    for i in range(3):
        jm, m = pair.step(deepfm_cols(BATCH, seed=40 + i))
        np.testing.assert_allclose(float(m["total_loss"]),
                                   float(jm["total_loss"]), rtol=1e-4)
    pair.assert_close(1e-5, param_tol=1e-4)


def test_clipping_acts_on_the_dense_gradients_only():
    """Norm clipping at a tiny bound moves the dense parameters by at most
    lr per step (sgd), and the sparse update not at all differently."""
    text = deepfm_config_text(
        BATCH, dense_opt="sgd_optimizer { lr: 0.1 momentum: 0 }"
        " constant_learning_rate {}",
        train_extra='  grad_clipping { clipping_type: "norm"'
        " max_gradient: 1e-6 }")
    clipped = PairedTrainers(text, TABLES, ["label"])
    free, features, _, free_state, free_step = port_options_setup(
        text.replace("max_gradient: 1e-6", "max_gradient: 1e6"),
        clipped.jmodel, clipped.jstate, TABLES)
    before = {k: v.clone() for k, v in clipped.model.state_dict().items()}
    cols = deepfm_cols(BATCH, seed=3)
    clipped.step(cols)
    free_step(free_state, DataParser(features, labels=["label"])
              .parse_to_batch(cols))
    moved = 0.0
    for k, v in clipped.model.state_dict().items():
        if "tables." in k:
            torch.testing.assert_close(v, free.state_dict()[k])
        else:
            moved += float(((v - before[k]) ** 2).sum())
    assert moved ** 0.5 <= 0.1 * 1e-6 * (1 + 1e-5)
    clipped.assert_close(1e-5, param_tol=1e-4)


# --- the FP16 grad scaler ---------------------------------------------------

FP16_TOL = 5e-3
DENSE_OPTS = {
    "adam": "adam_optimizer { lr: 0.01 } constant_learning_rate {}",
    "sgd": "sgd_optimizer { lr: 0.05 } constant_learning_rate {}"}
# step 0 overflows at 2^32 and backs off to 2^16; two finite steps grow it
SCALER = ("  grad_scaler { init_scale: 4294967296 backoff_factor: "
          "1.52587890625e-05 growth_interval: 2 growth_factor: 2 }")


@pytest.mark.parametrize("dense", ["adam", "sgd"])
@pytest.mark.parametrize("accum", [1, 2])
def test_grad_scaler_forced_overflow_matches_jax(accum, dense):
    """Step 0 overflows: every gradient is zeroed, the tables and the
    dense parameters keep their bits, and the dense optimizer's state
    moves on (adam's count, as the JAX package's ``tx.update`` does; with
    accumulation step 0 applies nothing anyway). The scale and the good
    steps follow the JAX package's step for step. With dense sgd the
    whole state is held at the fp16 tolerance after 5 steps; with adam
    the count (adam normalises each gradient element, so an element at
    fp16's rounding level can step either way in the two libraries)."""
    text = deepfm_config_text(
        BATCH, mixed_precision="FP16", sparse_opt="adam_optimizer { lr: 0.01"
        " eps: 1e-4 }", dense_opt=DENSE_OPTS[dense],
        train_extra=SCALER + f"\n  gradient_accumulation_steps: {accum}")
    pair = PairedTrainers(text, TABLES, ["label"])
    assert pair.model.compute_dtype == torch.float16
    scales = []
    for i in range(5):
        before = {k: v.clone() for k, v in pair.model.state_dict().items()}
        jbefore = jax.tree_util.tree_leaves(jax.device_get(
            (pair.jstate["dense"], pair.jstate["tables"])))
        jm, m = pair.step(deepfm_cols(BATCH, seed=60 + i))
        np.testing.assert_allclose(float(m["total_loss"]),
                                   float(jm["total_loss"]), rtol=FP16_TOL)
        sc, jsc = pair.state["scaler"], pair.jstate["scaler"]
        assert float(sc["scale"]) == float(jsc["scale"])
        assert int(sc["good_steps"]) == int(jsc["good_steps"])
        scales.append(float(sc["scale"]))
        if i == 0:  # skipped
            after = pair.model.state_dict()
            for k, v in before.items():
                assert torch.equal(after[k], v), k
            jafter = jax.tree_util.tree_leaves(jax.device_get(
                (pair.jstate["dense"], pair.jstate["tables"])))
            assert all(np.array_equal(a, b) for a, b in zip(jafter, jbefore))
        if dense == "adam":
            assert pair.tx.count == _adam_count(pair.jstate) == (
                i + 1 if accum == 1 else (i + 1) // accum)
    assert scales == [2.0 ** 16, 2.0 ** 16, 2.0 ** 17, 2.0 ** 17, 2.0 ** 18]
    if dense == "sgd":
        pair.assert_close(2e-2, param_tol=FP16_TOL, table_tol=FP16_TOL)


def test_grad_scaler_is_ignored_outside_fp16():
    for mp in ("", "BF16"):
        text = deepfm_config_text(BATCH, mixed_precision=mp,
                                  train_extra=SCALER)
        pair = PairedTrainers(text, TABLES, ["label"])
        assert "scaler" not in pair.state and "scaler" not in pair.jstate


# --- gradient accumulation --------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_jax(k):
    text = deepfm_config_text(
        BATCH, train_extra=f"  gradient_accumulation_steps: {k}")
    pair = PairedTrainers(text, TABLES, ["label"])
    for i in range(2 * k + 1):
        before = {n: p.clone() for n, p in pair.model.named_parameters()}
        pair.step(deepfm_cols(BATCH, seed=80 + i))
        moved = any(not torch.equal(p, before[n])
                    for n, p in pair.model.named_parameters())
        assert moved == ((i + 1) % k == 0)
        assert pair.tx.count == _adam_count(pair.jstate) == (i + 1) // k
        jacc = jax.tree_util.tree_leaves(pair.jstate["accum_grads"])
        assert len(jacc) == len(pair.state["accum_grads"])
        pair.assert_close(1e-5, param_tol=1e-4)
    # the window open after the last step: its sum, as the JAX one
    jsum = sum(float(np.abs(np.asarray(a)).sum())
               for a in jax.tree_util.tree_leaves(pair.jstate["accum_grads"]))
    got = sum(float(a.abs().sum()) for a in pair.state["accum_grads"])
    np.testing.assert_allclose(got, jsum, rtol=1e-4)


def _write_parquet(path, n_rows, seed):
    pq.write_table(pa.table(deepfm_cols(n_rows, seed=seed)), path)


def test_resume_mid_window_equals_the_straight_run(tmp_path):
    """FP16 with the scaler and accumulation over 2 steps: a run stopped
    and checkpointed after step 3 (mid-window, the step-3 gradients in
    ``accum_grads``) and resumed to step 6 ends where the straight run
    does, bit for bit; the checkpoint carries the accumulated gradients
    and the scaler."""
    inp = str(tmp_path / "train.parquet")
    _write_parquet(inp, 6 * BATCH, seed=5)
    extra = (SCALER.replace("4294967296", "1024")
             + "\n  gradient_accumulation_steps: 2")

    def run(model_dir, num_steps, cont=False):
        text = deepfm_config_text(BATCH, mixed_precision="FP16",
                                  model_dir=model_dir, num_steps=num_steps,
                                  train_extra=extra + "\n  "
                                  "save_checkpoints_steps: 3")
        cfg = str(tmp_path / f"{os.path.basename(model_dir)}.config")
        with open(cfg, "w") as f:
            f.write(text)
        return port_main.train_and_evaluate(
            cfg, train_input_path=inp, continue_train=cont, device="cpu")

    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    run(straight, 6)
    run(resumed, 3)
    mid = torch.load(checkpoint_util.checkpoint_path(resumed, 3),
                     weights_only=True)
    assert any(float(a.abs().sum()) > 0 for a in mid["accum_grads"])
    assert set(mid["scaler"]) == {"scale", "good_steps"}
    run(resumed, 6, cont=True)
    a = torch.load(checkpoint_util.checkpoint_path(straight, 6),
                   weights_only=True)
    b = torch.load(checkpoint_util.checkpoint_path(resumed, 6),
                   weights_only=True)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for x, y in zip(a["accum_grads"], b["accum_grads"]):
        assert torch.equal(x, y)
    assert {k: float(v) for k, v in a["scaler"].items()} == {
        k: float(v) for k, v in b["scaler"].items()}
    assert a["dense_opt"]["count"] == b["dense_opt"]["count"] == 3


# --- FP16 DLRM-HSTU ---------------------------------------------------------

def _jax_weights(jmodel, jstate, tables):
    eng = jmodel.embedding_group.engine
    return {k: v.numpy() for k, v in from_jax_state(
        jax.device_get(jstate["dense"]),
        {n: np.asarray(eng.extract_table(jstate["tables"], n), np.float32)
         for n in tables}).items()}


def test_fp16_dlrm_hstu_two_steps_match_jax():
    """The hstu_synth DLRM-HSTU at 2 STU layers in FP16, dense sgd: the
    JAX package runs its attention as its CPU tests do (the XLA version
    of the kernel's math), the port its plain fp16 version. The losses
    agree within the fp16 tolerance. FP16 moves this model far from its
    fp32 run (its timestamps pass fp16's range and become inf, which
    collapses the time buckets, in both packages); each weight of the
    port lies at least three times closer to the JAX FP16 run than that
    run lies to the JAX fp32 one (measured: 5 to 20 times)."""
    base = hstu_synth_train_config_text(4).replace(
        "adam_optimizer { lr: 0.002 }", "sgd_optimizer { lr: 0.05 }")
    text = base.replace(
        "train_config {", 'train_config {\n  mixed_precision: "FP16"', 1)
    pair = PairedTrainers(text, HSTU_TABLES, ["unused_label"])
    assert pair.model.compute_dtype == torch.float16
    _, jmodel32, jfeatures32, jstate32, jstep32 = jax_options_setup(base)
    parser32 = JaxParser(jfeatures32, labels=["unused_label"])
    for i in range(2):
        cols = synth_cols(4, seed=10 + i)
        jm, m = pair.step(cols)
        jstate32, _, _ = jstep32(jstate32, parser32.parse_to_batch(cols),
                                 jax.random.key(0))
        for k in jm:
            if not k.startswith("__"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=FP16_TOL, err_msg=k)
    j16 = _jax_weights(pair.jmodel, pair.jstate, HSTU_TABLES)
    j32 = _jax_weights(jmodel32, jstate32, HSTU_TABLES)
    sd = pair.model.state_dict()
    assert set(sd) == set(j16)
    for k, ref in j16.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        port = float(np.abs(sd[k].float().numpy() - ref).max()) / scale
        fp16 = float(np.abs(j32[k] - ref).max()) / scale
        assert port <= max(fp16, 2.0 ** -11) / 3, (k, port, fp16)


# --- the loop: steps_per_dispatch, train metrics, profiling -----------------

def _loop_config(tmp_path, name, extra, model_extra=""):
    text = deepfm_config_text(BATCH, model_dir=str(tmp_path / name),
                              num_steps=4, train_extra=extra)
    text = text.replace("  metrics { auc {} }",
                        "  metrics { auc {} }\n" + model_extra)
    path = str(tmp_path / f"{name}.config")
    with open(path, "w") as f:
        f.write(text)
    return path


def test_steps_per_dispatch_runs_single_steps(tmp_path, caplog):
    inp = str(tmp_path / "train.parquet")
    _write_parquet(inp, 4 * BATCH, seed=7)
    with caplog.at_level(logging.WARNING, logger="tzrec_tpu_torch"):
        port_main.train_and_evaluate(
            _loop_config(tmp_path, "k3", "  steps_per_dispatch: 3"),
            train_input_path=inp, device="cpu")
    assert sum("steps_per_dispatch" in r.message
               for r in caplog.records) == 1
    port_main.train_and_evaluate(_loop_config(tmp_path, "k1", ""),
                                 train_input_path=inp, device="cpu")
    a = torch.load(checkpoint_util.checkpoint_path(str(tmp_path / "k3"), 4),
                   weights_only=True)["model"]
    b = torch.load(checkpoint_util.checkpoint_path(str(tmp_path / "k1"), 4),
                   weights_only=True)["model"]
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_metrics_logged_from_the_step_predictions(tmp_path, caplog):
    """Train metrics with a decay step past the run: the logged train AUC
    is the AUC of every step's predictions and labels, recomputed from
    the detached predictions the step hands out."""
    inp = str(tmp_path / "train.parquet")
    _write_parquet(inp, 4 * BATCH, seed=9)
    cfg = _loop_config(
        tmp_path, "tm", "  log_step_count_steps: 2",
        "  train_metrics { auc {} decay_step: 1000 }\n"
        "  train_metrics { mean_absolute_error {} decay_step: 1000 }\n")
    with caplog.at_level(logging.INFO, logger="tzrec_tpu_torch"):
        port_main.train_and_evaluate(cfg, train_input_path=inp, device="cpu")
    lines = [r.message for r in caplog.records
             if r.message.startswith("step ")]
    assert len(lines) == 2 and all("train_auc=" in x and
                                   "train_mean_absolute_error=" in x
                                   for x in lines)

    # the same steps by hand: the step's predictions and the batch labels
    from torcheasyrec_tpu_torch import metrics as port_metrics
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    with open(cfg) as f:
        pcfg = parse_pipeline_config(f.read())
    model, features, sparse_sched = port_main._build_model_and_optim(
        pcfg, "cpu")
    tx, dense_sched = port_main._dense_optimizer(model, pcfg.train_config)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    state = port_main._init_state(model, tx)
    table = pq.read_table(inp)
    parser = DataParser(features, labels=["label"])
    tm = model.init_train_metrics()
    preds, labels = [], []
    for i in range(4):
        part = table.slice(i * BATCH, BATCH)
        batch = parser.parse_to_batch(
            {k: part[k].combine_chunks() for k in part.column_names})
        state, metrics = step(state, batch)
        p = metrics["__preds"]
        assert not p["probs"].requires_grad
        model.update_metrics(tm, p, batch)
        preds.append(p["probs"].numpy())
        labels.append(batch.labels["label"].numpy())
    want = port_metrics._auc(np.concatenate(preds), np.concatenate(labels))
    got = model.compute_metrics(tm)
    assert got["auc"] == want
    logged = float(lines[-1].split("train_auc=")[1].split()[0])
    assert abs(logged - want) < 1e-4


def test_is_profiling_writes_a_trace(tmp_path):
    inp = str(tmp_path / "train.parquet")
    _write_parquet(inp, 6 * BATCH, seed=11)
    cfg = _loop_config(tmp_path, "prof", "  is_profiling: true").replace(
        "num_steps: 4", "num_steps: 6")
    port_main.train_and_evaluate(cfg, train_input_path=inp, device="cpu")
    with open(tmp_path / "prof" / "profile" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("ProfilerStep" in n for n in names)

"""Export and artifact serving of the port against the JAX package (CPU,
fp32): rowwise quantization, fg.json, the mock table the export traces
over, DeepFM's artifact (fp32 and INT8 tables), DLRM-HSTU's artifact
with the attention operator in its program, the strict serialization,
the best checkpoint, the CLIs. The same seeded
inputs go through both packages; the JAX weights cross by
utils/convert.py. Predictions are held within 1e-5 of the JAX
package's."""

import glob
import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from test_train_integration import DEEPFM_CONFIG
from torch_port_helpers import (
    converted_state,
    hstu_synth_train_config_text,
    jax_model_and_state,
    synth_cols,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.acc import quant_util as jax_quant
from torcheasyrec_tpu.features import create_features as jax_create_features
from torcheasyrec_tpu.features.feature import create_fg_json as jax_fg_json
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu.utils import test_util as jax_test_util
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.acc import quant_util
from torcheasyrec_tpu_torch.features import create_features, create_fg_json
from torcheasyrec_tpu_torch.utils import checkpoint_util, test_util
from torcheasyrec_tpu_torch.utils.config_util import (
    load_pipeline_config,
    parse_pipeline_config,
)

PRED_TOL = dict(rtol=0, atol=1e-5)
OP = "tzrec_tpu_torch.hstu_attention_fwd"


def _read(path):
    """A predict output: the file, or the one file of a directory."""
    if os.path.isdir(path):
        path = os.path.join(path, sorted(os.listdir(path))[0])
    return pq.read_table(path)


def _column(table, name):
    return np.stack(table[name].to_numpy(zero_copy_only=False)).astype(
        np.float64)


def _jax_init_checkpoint(text, path):
    """The JAX package's initial weights of ``text`` saved at ``path`` as
    a port state_dict."""
    _, jmodel, _, dense, tables = jax_model_and_state(text)
    model, _ = port_main.build_model(parse_pipeline_config(text), "cpu")
    names = list(model.embedding_group.engine._specs)
    torch.save(converted_state(jmodel, dense, tables, names), path)


# -- quantization and fg.json --------------------------------------------


@pytest.mark.parametrize("dtype", quant_util.QUANT_DTYPES)
def test_quantize_rowwise_bit_equal_to_jax(dtype):
    table = (np.random.default_rng(0).normal(size=(100, 13)) * 0.1).astype(
        np.float32)
    table[7] = 0.0  # an all-zero row takes scale 1
    got = quant_util.quantize_rowwise(table, dtype)
    ref = jax_quant.quantize_rowwise(table, dtype)
    for k in ("values", "scales"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(
        quant_util.dequantize_rowwise(got, dtype, 13),
        jax_quant.dequantize_rowwise(ref, dtype, 13))


PINNED = sorted(
    glob.glob("torcheasyrec_tpu_torch/benchmark/configs/criteo_synth/*.config")
) + ["torcheasyrec_tpu_torch/benchmark/configs/hstu_synth/dlrm_hstu.config"]


@pytest.mark.parametrize("path", PINNED, ids=os.path.basename)
def test_create_fg_json_matches_jax(path):
    """fg.json of the features of every pinned config (13 criteo_synth,
    hstu_synth), from the port's copy and the JAX package's file."""
    assert len(PINNED) == 14
    port_cfg = load_pipeline_config(path)
    with open(path.replace("torcheasyrec_tpu_torch/", "torcheasyrec_tpu/")
              ) as f:
        jax_cfg = text_format.Parse(f.read(), jax_pb2.EasyRecConfig())
    got = create_fg_json(create_features(list(port_cfg.feature_configs)))
    ref = jax_fg_json(jax_create_features(list(jax_cfg.feature_configs)))
    assert got == ref
    assert json.dumps(got) == json.dumps(ref)


def test_mock_table_equals_jax():
    """The table the export traces over, value for value."""
    text = hstu_synth_train_config_text()
    port_feats = create_features(
        list(parse_pipeline_config(text).feature_configs))
    jax_feats = jax_create_features(list(
        text_format.Parse(text, jax_pb2.EasyRecConfig()).feature_configs))
    got = test_util.generate_mock_table(port_feats, 16, ["label"], seed=3)
    ref = jax_test_util.generate_mock_table(jax_feats, 16, ["label"], seed=3)
    assert got.equals(ref)


# -- DeepFM ----------------------------------------------------------------


@pytest.fixture(scope="module")
def deepfm(tmp_path_factory):
    """The JAX tests' DEEPFM_CONFIG, its mock data (the port's generator,
    equal to the JAX one), the JAX init as a port checkpoint."""
    root = str(tmp_path_factory.mktemp("deepfm"))
    text = DEEPFM_CONFIG.format(
        train=os.path.join(root, "train.parquet"),
        eval=os.path.join(root, "eval.parquet"),
        model_dir=os.path.join(root, "model"))
    cfg_path = os.path.join(root, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    features = create_features(
        list(parse_pipeline_config(text).feature_configs))
    eval_path = os.path.join(root, "eval.parquet")
    test_util.write_mock_parquet(eval_path, features, 256, ["label"], seed=1)
    init = os.path.join(root, "init.pt")
    _jax_init_checkpoint(text, init)
    return root, cfg_path, eval_path, init


def test_deepfm_export_predict_matches_jax(deepfm, monkeypatch):
    root, cfg_path, eval_path, init = deepfm
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_dir = os.path.join(root, "jax_export")
    jax_main.export(cfg_path, jax_dir)
    jax_out = os.path.join(root, "jax_preds")
    jax_main.predict(eval_path, jax_out, jax_dir)

    port_dir = os.path.join(root, "port_export")
    port_main.export(cfg_path, port_dir, checkpoint_path=init, device="cpu")
    for name in ("pipeline.config", "fg.json", "model/model.pt",
                 port_main.PREDICT_PROGRAM, port_main.SERVING_SPEC):
        assert os.path.exists(os.path.join(port_dir, name)), name
    with open(os.path.join(port_dir, "fg.json")) as f, open(
            os.path.join(jax_dir, "fg.json")) as g:
        assert json.load(f) == json.load(g)
    with open(os.path.join(port_dir, port_main.SERVING_SPEC)) as f:
        spec = json.load(f)
    assert spec["batch_size"] == 128 and spec["platforms"] == ["cpu"]
    assert spec["num_inputs"] == 3  # cat_a, cat_b, num_a; no label
    port_out = os.path.join(root, "port_preds.parquet")
    n = port_main.predict(eval_path, port_out, port_dir,
                          reserved_columns="cat_a", device="cpu")
    assert n == 256
    got, ref = _read(port_out), _read(jax_out)
    np.testing.assert_array_equal(got["cat_a"].to_numpy(),
                                  pq.read_table(eval_path)["cat_a"].to_numpy())
    for k in ("probs", "logits"):
        np.testing.assert_allclose(got[k].to_numpy(), ref[k].to_numpy(),
                                   err_msg=k, **PRED_TOL)


def test_deepfm_int8_export_matches_jax(deepfm, monkeypatch):
    """QUANT_EMB=INT8: the quantized tables bit-equal to the JAX
    package's (its co-keyed table merge off, so both group alike), the
    predictions within 1e-5 of its quantized ones and within 0.05 of the
    fp32 artifact's, as the JAX test bounds them; no program."""
    root, cfg_path, eval_path, init = deepfm
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    monkeypatch.setenv("TZREC_TABLE_MERGE", "0")
    monkeypatch.setenv("QUANT_EMB", "INT8")
    jax_dir = os.path.join(root, "jax_int8")
    jax_main.export(cfg_path, jax_dir)
    port_dir = os.path.join(root, "port_int8")
    port_main.export(cfg_path, port_dir, checkpoint_path=init, device="cpu")
    monkeypatch.delenv("QUANT_EMB")
    assert not os.path.exists(os.path.join(port_dir,
                                           port_main.PREDICT_PROGRAM))
    with open(os.path.join(port_dir, "quant_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jax_dir, "quant_meta.json")) as f:
        jmeta = json.load(f)
    assert meta["dtype"] == jmeta["dtype"] == "INT8"

    # the port's group "d<dim>" is the JAX group "d<dim>_<sharding>"
    def by_dim(groups):
        return {v["dim"]: (k, v["rows"]) for k, v in groups.items()}

    assert sorted(by_dim(meta["groups"])) == [4, 8]
    for dim, (gk, rows) in by_dim(meta["groups"]).items():
        jgk, jrows = by_dim(jmeta["groups"])[dim]
        assert rows == jrows
        got = np.load(os.path.join(port_dir, "quant_tables", f"{gk}.npz"))
        ref = np.load(os.path.join(jax_dir, "quant_tables", f"{jgk}.npz"))
        for k in ("values", "scales"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=(dim, k))
    jax_out = os.path.join(root, "jax_int8_preds")
    jax_main.predict(eval_path, jax_out, jax_dir)
    port_out = os.path.join(root, "port_int8_preds.parquet")
    port_main.predict(eval_path, port_out, port_dir, device="cpu")
    fp32_out = os.path.join(root, "port_fp32_preds.parquet")
    fp32_dir = os.path.join(root, "port_fp32")
    port_main.export(cfg_path, fp32_dir, checkpoint_path=init, device="cpu")
    port_main.predict(eval_path, fp32_out, fp32_dir, device="cpu")
    got = _read(port_out)["probs"].to_numpy()
    np.testing.assert_allclose(got, _read(jax_out)["probs"].to_numpy(),
                               **PRED_TOL)
    assert np.abs(got - _read(fp32_out)["probs"].to_numpy()).max() < 0.05


def test_export_and_predict_clis(deepfm, tmp_path):
    """``python -m torcheasyrec_tpu_torch.export`` writes the artifact;
    ``predict`` with ``--scripted_model_path`` predicts from it, and with
    ``--pipeline_config_path`` from the checkpoint, to the same numbers."""
    import subprocess
    import sys

    _, cfg_path, eval_path, init = deepfm
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def run(*args):
        res = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                             cwd=repo, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]

    export_dir = str(tmp_path / "export")
    run("torcheasyrec_tpu_torch.export", "--pipeline_config_path", cfg_path,
        "--export_dir", export_dir, "--checkpoint_path", init)
    assert os.path.exists(os.path.join(export_dir, port_main.PREDICT_PROGRAM))
    art, ckpt = str(tmp_path / "a.parquet"), str(tmp_path / "c.parquet")
    run("torcheasyrec_tpu_torch.predict", "--scripted_model_path",
        export_dir, "--predict_input_path", eval_path,
        "--predict_output_path", art)
    run("torcheasyrec_tpu_torch.predict", "--pipeline_config_path",
        cfg_path, "--checkpoint_path", init, "--predict_input_path",
        eval_path, "--predict_output_path", ckpt)
    assert _read(art).equals(_read(ckpt))


def test_tdm_export_raises(tmp_path):
    """TDM's export (from the seeded init) writes the split layout:
    ``embedding/`` with the node features' program, ``tower.json`` and
    ``fg.json``, and the whole model under ``model/``; nothing at the
    root (tests/test_torch_port_tdm.py holds both against the JAX
    package's)."""
    from test_torch_port_tdm import config_text

    path = str(tmp_path / "tdm.config")
    with open(path, "w") as f:
        f.write(config_text(str(tmp_path), str(tmp_path / "model")))
    export_dir = str(tmp_path / "export")
    port_main.export(path, export_dir, device="cpu")
    assert sorted(os.listdir(export_dir)) == ["embedding", "model"]
    emb, whole = (os.path.join(export_dir, d) for d in ("embedding", "model"))
    for name in ("tower_fn.pt2", "serving_spec.json", "pipeline.config",
                 "fg.json", "model"):
        assert os.path.exists(os.path.join(emb, name)), name
    with open(os.path.join(emb, "tower.json")) as f:
        assert json.load(f) == {"tower": "embedding", "seq_group": "seq",
                                "output": "item_emb",
                                "features": ["item_id"]}
    with open(os.path.join(emb, "fg.json")) as f:
        assert [c["feature_name"] for c in json.load(f)["features"]] == [
            "item_id"]
    for name in ("predict_fn.pt2", "serving_spec.json", "pipeline.config",
                 "fg.json", "model"):
        assert os.path.exists(os.path.join(whole, name)), name


# -- DLRM-HSTU: the attention operator in the program ----------------------


@pytest.fixture(scope="module")
def hstu(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hstu"))
    text = hstu_synth_train_config_text(batch_size=4, num_layers=2)
    text = re.sub(r'model_dir: ".*"',
                  f'model_dir: "{os.path.join(root, "model")}"', text)
    cfg_path = os.path.join(root, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    cfg = parse_pipeline_config(text)
    init = os.path.join(root, "init.pt")
    _jax_init_checkpoint(text, init)
    export_dir = os.path.join(root, "export")
    port_main.export(cfg_path, export_dir, checkpoint_path=init,
                     device="cpu")
    return root, cfg_path, cfg, init, export_dir


def test_dlrm_hstu_program_holds_the_op_and_equals_eager(hstu):
    _, _, cfg, init, export_dir = hstu
    program = torch.export.load(
        os.path.join(export_dir, port_main.PREDICT_PROGRAM))
    ops = [n for n in program.graph.nodes
           if n.op == "call_function" and str(n.target).startswith(OP)]
    assert len(ops) == 2  # one per STU layer
    model, features = port_main.build_model(cfg, "cpu")
    checkpoint_util.load_model_weights(init, model)
    _, batch = port_main.serving_batch(cfg, features, "cpu")
    leaves = torch.utils._pytree.tree_flatten(batch)[0]
    with open(os.path.join(export_dir, port_main.SERVING_SPEC)) as f:
        assert json.load(f)["num_inputs"] == len(leaves)
    got = program.module()(*leaves)
    ref, _ = port_main.make_eval_step(model, with_loss=False)(batch)
    assert sorted(got) == sorted(k for k in ref if not k.startswith("__"))
    for k in got:
        assert torch.equal(got[k], ref[k]), k


LOAD_ALONE = """
import sys
import torch
import torcheasyrec_tpu_torch.ops.hstu
program, inputs, out = sys.argv[1:4]
leaves = torch.load(inputs, weights_only=True)
with torch.inference_mode():
    got = torch.export.load(program).module()(*leaves)
torch.save(got, out)
port = sorted(m for m in sys.modules if m.startswith("torcheasyrec_tpu_torch"))
assert not any(".models" in m or m.endswith(".main") for m in port), port
assert not any(m.split(".")[0] in ("jax", "torcheasyrec_tpu")
               for m in sys.modules)
"""


def test_dlrm_hstu_program_loads_without_the_model_code(hstu, tmp_path):
    """A process that imports torch and the operator's module only loads
    and runs the program, to the eager eval step's bits; without that
    import the program does not load."""
    import subprocess
    import sys

    _, _, cfg, init, export_dir = hstu
    model, features = port_main.build_model(cfg, "cpu")
    checkpoint_util.load_model_weights(init, model)
    _, batch = port_main.serving_batch(cfg, features, "cpu")
    inputs, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out.pt")
    torch.save(torch.utils._pytree.tree_flatten(batch)[0], inputs)
    program = os.path.join(export_dir, port_main.PREDICT_PROGRAM)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", LOAD_ALONE, program, inputs,
                          out], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(out, weights_only=True)
    ref, _ = port_main.make_eval_step(model, with_loss=False)(batch)
    for k in got:
        assert torch.equal(got[k], ref[k]), k
    bare = LOAD_ALONE.replace("import torcheasyrec_tpu_torch.ops.hstu\n", "")
    res = subprocess.run([sys.executable, "-c", bare, program, inputs, out],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and "hstu_attention_fwd" in res.stderr


def test_dlrm_hstu_artifact_predict_matches_jax(hstu, monkeypatch):
    root, cfg_path, _, _, export_dir = hstu
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    inp = os.path.join(root, "requests.parquet")
    pq.write_table(pa.table(synth_cols(6, seed=5)), inp)
    jax_dir = os.path.join(root, "jax_export")
    jax_main.export(cfg_path, jax_dir)
    jax_out = os.path.join(root, "jax_preds")
    jax_main.predict(inp, jax_out, jax_dir)
    port_out = os.path.join(root, "port_preds.parquet")
    assert port_main.predict(inp, port_out, export_dir, device="cpu") == 6
    got, ref = _read(port_out), _read(jax_out)
    keys = [k for k in ref.column_names if k.startswith("probs_")]
    assert len(keys) == 2
    for k in keys:
        np.testing.assert_allclose(_column(got, k), _column(ref, k),
                                   err_msg=k, **PRED_TOL)


# -- strictness, best checkpoint -------------------------------------------


def test_program_export_is_strict(tmp_path, monkeypatch):
    """A failing serialization raises, unless TZREC_EXPORT_BEST_EFFORT=1
    downgrades it to a warning."""
    cfg = parse_pipeline_config("""
        data_config { batch_size: 4 dataset_type: ParquetDataset
                      fg_mode: FG_NONE label_fields: "label" }
        feature_configs { id_feature { feature_name: "a" num_buckets: 10
                                       embedding_dim: 4 } }
        model_config { feature_groups { group_name: "wide"
                       feature_names: "a" group_type: WIDE }
                       feature_groups { group_name: "deep"
                       feature_names: "a" group_type: DEEP }
                       deepfm { deep { hidden_units: [4] } }
                       num_class: 1 }
        """)
    model, features = port_main.build_model(cfg, "cpu")

    def broken_fn(batch):
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="serving program export failed"):
        port_main._serialize_program(cfg, features, broken_fn, model,
                                     str(tmp_path), "x.pt2")
    monkeypatch.setenv("TZREC_EXPORT_BEST_EFFORT", "1")
    port_main._serialize_program(cfg, features, broken_fn, model,
                                 str(tmp_path), "x.pt2")
    assert not os.path.exists(tmp_path / "x.pt2")


@pytest.mark.parametrize("larger", [True, False])
def test_best_checkpoint_matches_jax(tmp_path, larger):
    """One eval-result file, both packages: the same pick in both
    directions of ``metric_larger_is_better``; where the best line's
    checkpoint is gone, neither picks one."""
    lines = [{"global_step": 2, "auc": 0.61}, {"global_step": 4, "auc": 0.7},
             {"global_step": 6, "auc": 0.55}, {"global_step": 8, "auc": 0.2}]
    with open(tmp_path / "train_eval_result_v2.txt", "w") as f:
        f.write("\n".join(json.dumps(r) for r in lines) + "\nnot json\n")
    for step in (2, 4, 6):
        open(tmp_path / f"model.ckpt-{step}.pt", "w").close()  # the port's
        (tmp_path / f"model.ckpt-{step}").mkdir()  # the JAX package's
    text = (f'export_config {{ exporter_type: "best" '
            f'best_exporter_metric: "auc" '
            f'metric_larger_is_better: {str(larger).lower()} }}')
    got = port_main._best_checkpoint(parse_pipeline_config(text),
                                     str(tmp_path))
    ref = jax_main._best_checkpoint(
        text_format.Parse(text, jax_pb2.EasyRecConfig()), str(tmp_path))
    if larger:
        assert ref == str(tmp_path / "model.ckpt-4")
        assert got == checkpoint_util.checkpoint_path(str(tmp_path), 4)
    else:  # the best line is step 8, whose checkpoint is gone
        assert ref is None and got is None

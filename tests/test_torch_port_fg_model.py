"""The FG slice as a whole: a narrow MultiTowerDIN with one feature of
every kind, fed raw columns (``fg_mode: FG_NORMAL``), in both packages
from the JAX package's initial weights (``utils/convert.py``): the
forward and the losses of two train steps within 1e-5 of each tensor's
max; the port's entry points on the same config (train_and_evaluate,
evaluate, export with ``fg.json``, the artifact's predict with and
without INPUT_TILE, predict_checkpoint); and the FG tools against the
JAX package's."""

import json
import os
import runpy
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from torch_port_helpers import (
    PairedTrainers,
    assert_close_to_max,
    ready_jax_fg_native,
)
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.benchmark import fg_synth
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.features import feature as feature_mod

BATCH = 64
DENSE_LANE = 100
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_fg_native():
    """The JAX package's FG natives, loaded whole before any test here
    (``torch_port_helpers.ready_jax_fg_native``)."""
    ready_jax_fg_native()


@pytest.fixture(scope="module")
def fg_files(tmp_path_factory):
    from torcheasyrec_tpu.features.other_features import register_custom_op

    d = str(tmp_path_factory.mktemp("fg_model"))
    fg_synth.register_fg_ops()
    register_custom_op(fg_synth.CUSTOM_OP, fg_synth._len_mod)
    paths = {"vocab": fg_synth.write_city_vocab(os.path.join(d, "v.txt")),
             "spm": fg_synth.write_spm_model(os.path.join(d, "s.model")),
             "root": d}
    for name, n, seed, per_user in (("train", 4 * BATCH, 1, 1),
                                    ("eval", 2 * BATCH, 2, 1),
                                    ("req", 2 * BATCH, 3, BATCH)):
        paths[name] = os.path.join(d, f"{name}.parquet")
        pq.write_table(pa.table(fg_synth.fg_raw_cols(
            n, seed, rows_per_user=per_user)), paths[name])
    return paths


def _text(paths, model_dir="unused", **kw):
    return fg_synth.fg_din_config_text(
        paths["train"], paths["eval"], model_dir, paths["vocab"],
        paths["spm"], BATCH, **kw)


def test_two_train_steps_match_jax(fg_files, monkeypatch):
    monkeypatch.setenv("TZREC_DENSE_LANE", str(DENSE_LANE))
    monkeypatch.setenv("TZREC_PACKED", "1")
    text = _text(fg_files, with_combine=False)
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(text)
    probe, _, _ = port_main._build_model_and_optim(cfg, "cpu")
    tables = sorted(probe.embedding_group.tables)
    assert {"item_emb", "uid_emb", "tok_emb", "cus_emb"} <= set(tables)
    import jax

    pair = PairedTrainers(text, tables, ["label"],
                          dense_lane_rows=DENSE_LANE)
    for seed in (11, 12):
        jm, m = pair.step(fg_synth.fg_raw_cols(BATCH, seed))
        for k in ("binary_cross_entropy", "total_loss"):
            assert_close_to_max(float(m[k]), float(jm[k]), k, TOL)
    # the forward after the steps (the tables' rowwise adagrad turns the
    # two packages' rounding into row steps of ~1e-5 of a table's max:
    # the weights are held through the outputs they give)
    import jax.numpy as jnp

    from torcheasyrec_tpu import main as jax_main

    cols = fg_synth.fg_raw_cols(BATCH, 13)
    jpreds, _ = jax_main.make_eval_step(pair.jmodel, jnp.float32)(
        {"dense": pair.jstate["dense"], "tables": pair.jstate["tables"]},
        pair._jparser.parse_to_batch(cols))
    preds, _ = port_main.make_eval_step(pair.model)(
        pair._parser.parse_to_batch(cols))
    for k in ("logits", "probs"):
        assert_close_to_max(preds[k].numpy(), np.asarray(jax.device_get(
            jpreds[k])), k, TOL)


def _user_rows(monkeypatch):
    """Record the rows each user-side feature's parse reads."""
    seen = []
    parse = feature_mod.BaseFeature.parse

    def recording(self, data, is_training=False):
        if self.is_user_side:
            seen.append((self.name, len(data[self.inputs[0]])))
        return parse(self, data, is_training)

    monkeypatch.setattr(feature_mod.BaseFeature, "parse", recording)
    return seen


def test_entry_points_and_input_tile(fg_files, tmp_path, monkeypatch):
    model_dir = str(tmp_path / "model")
    cfg_path = str(tmp_path / "fg.config")
    with open(cfg_path, "w") as f:
        f.write(_text(fg_files, model_dir, fg_threads=2))
    result = port_main.train_and_evaluate(cfg_path, device="cpu")
    assert result["step"] == 4 and np.isfinite(result["auc"])
    again = port_main.evaluate(cfg_path, device="cpu")
    assert again["auc"] == result["auc"]

    export_dir = str(tmp_path / "export")
    port_main.export(cfg_path, export_dir, device="cpu")
    assert os.path.exists(os.path.join(export_dir, "predict_fn.pt2"))
    tool_dir = str(tmp_path / "fg_tool")
    from torcheasyrec_tpu_torch.tools.create_fg_json import write_fg_json

    with open(write_fg_json(cfg_path, tool_dir)) as f:
        tool_fg = json.load(f)
    with open(os.path.join(export_dir, "fg.json")) as f:
        assert json.load(f) == tool_fg
    assert {e["feature_name"] for e in tool_fg["features"]} >= {
        "cmb", "cus", "tok", "click_seq"}

    outs = {}
    for tile in ("", "2"):
        monkeypatch.setenv("INPUT_TILE", tile)
        with pytest.MonkeyPatch.context() as mp:
            seen = _user_rows(mp)
            out = str(tmp_path / f"pred{tile}.parquet")
            assert port_main.predict(fg_files["req"], out, export_dir,
                                     batch_size=BATCH, device="cpu") == (
                2 * BATCH)
        # with tiling each request's five user-side features parse one
        # row (outside the DAG); without, the Python parses read them all
        if tile:
            assert sorted(seen) == sorted(
                [(n, 1) for n in ("uid", "city", "tags_w", "age_b",
                                  "click_seq")] * 2)
        else:
            assert {n for _, n in seen} == {BATCH}
        outs[tile] = pq.read_table(out)
    for k in ("logits", "probs"):
        np.testing.assert_array_equal(np.asarray(outs["2"][k]),
                                      np.asarray(outs[""][k]))
    monkeypatch.delenv("INPUT_TILE")
    n = port_main.predict_checkpoint(
        cfg_path, fg_files["eval"], str(tmp_path / "ck.parquet"),
        reserved_columns="user_id", device="cpu")
    assert n == 2 * BATCH
    t = pq.read_table(str(tmp_path / "ck.parquet"))
    assert t.column("user_id").to_pylist() == pq.read_table(
        fg_files["eval"]).column("user_id").to_pylist()


def test_tools_write_what_the_jax_tools_write(fg_files, tmp_path):
    from torcheasyrec_tpu.tools.create_online_infer_data import (
        create_online_data as jax_online,
    )
    from torcheasyrec_tpu_torch.tools.create_fg_json import write_fg_json
    from torcheasyrec_tpu_torch.tools.create_online_infer_data import (
        create_online_data,
    )

    cfg_path = str(tmp_path / "fg.config")
    with open(cfg_path, "w") as f:
        f.write(_text(fg_files, with_combine=False))
    argv = sys.argv
    try:
        sys.argv = ["create_fg_json", "--pipeline_config_path", cfg_path,
                    "--fg_output_dir", str(tmp_path / "jax")]
        runpy.run_module("torcheasyrec_tpu.tools.create_fg_json",
                         run_name="__main__")
    finally:
        sys.argv = argv
    port = write_fg_json(cfg_path, str(tmp_path / "port"))
    with open(port) as a, open(tmp_path / "jax" / "fg.json") as b:
        assert a.read() == b.read()
    jax_online(cfg_path, str(tmp_path / "jax.jsonl"), 7)
    assert create_online_data(cfg_path, str(tmp_path / "port.jsonl"), 7) == 7
    with open(tmp_path / "port.jsonl") as a, open(
            tmp_path / "jax.jsonl") as b:
        assert a.read() == b.read()


def test_tile_size_rides_the_batch():
    """``Batch.tile_size`` survives ``to``, ``to_numpy``/``from_numpy``
    and ``pin_memory``'s map; a parser without INPUT_TILE leaves it
    None."""
    import torch

    from torcheasyrec_tpu_torch.datasets.utils import Batch, DenseField

    b = Batch(dense_features={"x": DenseField(torch.ones(2, 1))},
              tile_size=5)
    assert b.to("cpu").tile_size == 5
    assert b.to_numpy().from_numpy().tile_size == 5
    assert DataParser([]).parse_to_batch({}).tile_size is None

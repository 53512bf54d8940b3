"""The port's checkpointed training loop on the CPU, with a small DeepFM
over a directory of parquet files:

- ``train_and_evaluate`` of the port and of the JAX package from the
  same weights (the JAX init carried across by utils/convert.py through
  ``fine_tune_checkpoint``) save at the same steps with the same
  dataloader watermark, and their evals agree: AUC and ``loss_*`` within
  rtol 1e-4 / atol 1e-5, the tolerance of the DeepFM parity tests;
- 3 (or 5) steps, then ``continue_train`` to 6, give tables, optimizer
  states, step and watermark bit-equal to 6 steps straight, mid-file and
  across an epoch boundary, where the next epoch replays every row;
- ``keep_checkpoint_max`` prunes the oldest checkpoints, one eval line
  per save;
- ``edit_config_json`` edits as the JAX ``edit_config`` does;
- ``predict_checkpoint`` carries the reserved columns through."""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import (
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    jax_model_and_state,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu.utils import checkpoint_util as jax_ckpt
from torcheasyrec_tpu.utils import config_util as jax_config_util
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 32
# 175 rows: 5 train batches an epoch (15 rows dropped), step 3 mid file 1,
# steps 4-5 in file 2, step 6 the first batch of the second epoch
SIZES = (70, 45, 60)
EVAL_ROWS = 90  # at eval_batch_size 40: batches of 40, 40 and 10


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    start = 0
    for i, n in enumerate(SIZES):
        cols = deepfm_cols(n, seed=60 + i)
        cols["rid"] = pa.array(np.arange(start, start + n, dtype=np.int64))
        pq.write_table(pa.table(cols),
                       os.path.join(train_dir, f"part-{i}.parquet"),
                       row_group_size=16)
        start += n
    for i, n in enumerate((50, EVAL_ROWS - 50)):
        pq.write_table(pa.table(deepfm_cols(n, seed=90 + i)),
                       os.path.join(root, f"eval-{i}.parquet"))
    return root, train_dir, os.path.join(root, "eval-*.parquet")


def _config(path, model_dir, train_dir, eval_glob, num_steps=6,
            train_extra="", **kw):
    text = deepfm_config_text(BATCH, model_dir=model_dir,
                              num_steps=num_steps, **kw)
    text = text.replace('train_input_path: "unused"',
                        f'train_input_path: "{train_dir}"')
    text = text.replace('eval_input_path: "unused"',
                        f'eval_input_path: "{eval_glob}"')
    text = text.replace(f"  num_steps: {num_steps}",
                        f"  num_steps: {num_steps}\n{train_extra}")
    text = text.replace(f"  batch_size: {BATCH}",
                        f"  batch_size: {BATCH}\n  eval_batch_size: 40")
    with open(path, "w") as f:
        f.write(text)
    return path, text


def _eval_lines(model_dir):
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        return [json.loads(line) for line in f]


def _port_ckpt(model_dir, step):
    return torch.load(checkpoint_util.checkpoint_path(model_dir, step),
                      weights_only=True)


def test_train_and_evaluate_matches_jax(data, tmp_path, monkeypatch):
    """Both packages, 6 steps over the directory (into the second epoch),
    a save and an eval every 2 steps and at the end, the eval input a
    glob of two files (read, not skipped) at eval_batch_size 40."""
    root, train_dir, eval_glob = data
    extra = "  save_checkpoints_steps: 2\n"
    jax_dir = str(tmp_path / "jax")
    jax_cfg, text = _config(str(tmp_path / "jax.config"), jax_dir, train_dir,
                            eval_glob, train_extra=extra)
    # the JAX trainer on one device, as the port's (no 8-device mesh)
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_main.train_and_evaluate(jax_cfg)

    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = str(tmp_path / "jax_init.pt")
    torch.save(converted_state(jmodel, dense, tables, deepfm_table_names()),
               init)
    port_dir = str(tmp_path / "port")
    port_cfg, _ = _config(str(tmp_path / "port.config"), port_dir, train_dir,
                          eval_glob, train_extra=extra)
    result = port_main.train_and_evaluate(port_cfg, fine_tune_checkpoint=init,
                                          device="cpu")
    assert result["step"] == 6.0

    assert sorted(checkpoint_util.list_checkpoints(port_dir)) == [2, 4, 6]
    for step, want in ((2, {0: 63}), (4, {0: 69, 1: 44, 2: 12}),
                       (6, {0: 31})):
        jstate = jax_ckpt.load_dataloader_state(
            os.path.join(jax_dir, f"model.ckpt-{step}"))
        assert _port_ckpt(port_dir, step)["dataloader_state"] == jstate == want
    ours, ref = _eval_lines(port_dir), _eval_lines(jax_dir)
    assert [r["global_step"] for r in ours] == [
        r["global_step"] for r in ref] == [2, 4, 6, 6]
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"global_step", "auc",
                                    "loss_binary_cross_entropy"}
        for k in ("auc", "loss_binary_cross_entropy"):
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
    assert result["auc"] == ours[-1]["auc"]


def _assert_same_checkpoint(a, b):
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    assert a["dataloader_state"] == b["dataloader_state"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["sparse_opt"].keys() == b["sparse_opt"].keys()
    for t in a["sparse_opt"]:
        for k in a["sparse_opt"][t]:
            assert torch.equal(a["sparse_opt"][t][k], b["sparse_opt"][t][k])
    assert a["dense_opt"]["count"] == b["dense_opt"]["count"]
    assert len(a["dense_opt"]["state"]) == len(b["dense_opt"]["state"])
    for i, (st, st_b) in enumerate(zip(a["dense_opt"]["state"],
                                       b["dense_opt"]["state"])):
        assert st.keys() == st_b.keys()
        for k in st:
            assert torch.equal(st[k], st_b[k]), (i, k)


@pytest.mark.parametrize("resume_at,epoch", [(3, 0), (5, 0)],
                         ids=["mid_file", "at_the_epoch_boundary"])
def test_continue_train_is_bit_equal_to_a_straight_run(data, tmp_path,
                                                       resume_at, epoch):
    """Step 3 is mid-file (rows 0-95: file 1 is half read); step 5 has
    read all of epoch 0 but its dropped remainder, so the resumed epoch is
    empty and step 6 comes from the replay of every row."""
    _, train_dir, eval_glob = data
    straight_dir = str(tmp_path / "straight")
    cfg, _ = _config(str(tmp_path / "a.config"), straight_dir, train_dir, "")
    port_main.train_and_evaluate(cfg, device="cpu")
    resumed_dir = str(tmp_path / "resumed")
    cfg, _ = _config(str(tmp_path / "b.config"), resumed_dir, train_dir, "")
    first = port_main.train_and_evaluate(
        cfg, device="cpu",
        edit_config_json=json.dumps({"train_config.num_steps": resume_at}))
    assert first["step"] == resume_at
    mid = _port_ckpt(resumed_dir, resume_at)
    assert mid["epoch"] == epoch
    assert mid["dataloader_state"] == {3: {0: 69, 1: 25},
                                       5: {0: 69, 1: 44, 2: 44}}[resume_at]
    again = port_main.train_and_evaluate(cfg, continue_train=True,
                                         device="cpu")
    assert again["step"] == 6.0
    _assert_same_checkpoint(_port_ckpt(resumed_dir, 6),
                            _port_ckpt(straight_dir, 6))
    assert _port_ckpt(resumed_dir, 6)["epoch"] == 1


def test_keep_checkpoint_max_prunes_the_oldest(data, tmp_path):
    _, train_dir, eval_glob = data
    model_dir = str(tmp_path / "model")
    cfg, _ = _config(str(tmp_path / "c.config"), model_dir, train_dir,
                     eval_glob, num_steps=4,
                     train_extra="  save_checkpoints_steps: 1\n"
                     "  keep_checkpoint_max: 2\n")
    port_main.train_and_evaluate(cfg, device="cpu")
    # tb: the TensorBoard summaries (use_tensorboard defaults to true)
    assert sorted(os.listdir(model_dir)) == [
        "model.ckpt-3.pt", "model.ckpt-4.pt", "pipeline.config", "tb",
        "train_eval_result_v2.txt"]
    # one eval per save: steps 1-4 and the final save at 4
    assert [r["global_step"] for r in _eval_lines(model_dir)] == [
        1, 2, 3, 4, 4]


EDITS = {
    "train_config.num_steps": "7",
    "feature_configs[feature_name=cat_0].id_feature.embedding_dim": "4",
    "feature_configs[1].id_feature.num_buckets": "77",
    "model_config.deepfm.deep.hidden_units": "[8, 4]",
    "data_config.dataset_type": "ParquetDataset",
    "data_config.drop_remainder": "true",
    "train_config.sparse_optimizer": "adagrad_optimizer { lr: 0.2 }",
}


def test_edit_config_json_edits_as_jax():
    text = deepfm_config_text(BATCH)
    port = config_util.edit_config(config_util.parse_pipeline_config(text),
                                   dict(EDITS))
    ref = jax_config_util.edit_config(
        text_format.Parse(text, jax_pb2.EasyRecConfig()), dict(EDITS))
    assert text_format.MessageToString(port) == text_format.MessageToString(
        ref)
    assert port.train_config.num_steps == 7
    assert list(port.model_config.deepfm.deep.hidden_units) == [8, 4]


def test_predict_checkpoint_keeps_reserved_columns(data, tmp_path):
    """The predict-mode loader carries ``rid`` from every row of the
    directory to the output, in order, beside the predictions of the
    checkpoint, at eval_batch_size 40 (five batches, the last short)."""
    _, train_dir, eval_glob = data
    model_dir = str(tmp_path / "model")
    cfg, _ = _config(str(tmp_path / "d.config"), model_dir, train_dir, "",
                     num_steps=2)
    port_main.train_and_evaluate(cfg, device="cpu")
    out = str(tmp_path / "out")
    n = port_main.predict_checkpoint(cfg, train_dir, out,
                                     reserved_columns="rid", device="cpu")
    assert n == sum(SIZES)
    written = pq.read_table(os.path.join(out, "part-0.parquet"))
    assert written.column_names[0] == "rid"
    assert set(written.column_names) == {"rid", "logits", "probs"}
    np.testing.assert_array_equal(written["rid"].to_numpy(),
                                  np.arange(sum(SIZES)))
    model, features = port_main.build_model(
        config_util.load_pipeline_config(cfg), "cpu")
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(model_dir), model)
    eval_step = port_main.make_eval_step(model, with_loss=False)
    dl = create_dataloader(config_util.load_pipeline_config(cfg).data_config,
                           features, train_dir, mode="predict", device="cpu")
    probs = torch.cat([eval_step(b)[0]["probs"] for b, _ in dl()])
    assert torch.equal(torch.from_numpy(written["probs"].to_numpy()), probs)

"""F9: the port's ``train_and_evaluate`` writes the TensorBoard scalars
the JAX loop writes (``<model_dir>/tb``: ``loss/<name>`` and
``learning_rate`` every ``log_step_count_steps`` steps, ``eval/<metric>``
at the end), held against the JAX package's event files from the same
weights: the same tags at the same steps, the learning rate equal, the
losses and the eval within rtol 1e-4 / atol 1e-5 (the DeepFM parity
tolerance). Without ``torch.utils.tensorboard`` the writer warns and
writes nothing."""

import logging
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from torch_port_helpers import (
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    jax_model_and_state,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu_torch import main as port_main

TOL = dict(rtol=1e-4, atol=1e-5)


def _scalars(model_dir):
    """{tag: [(step, value)]} of the event files under ``model_dir/tb``."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(os.path.join(model_dir, "tb"))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_f9_tensorboard_scalars_match_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    tbl = pa.table(deepfm_cols(512, 11))
    train, evalp = (os.path.join(root, f) for f in ("train.parquet",
                                                     "eval.parquet"))
    pq.write_table(tbl.slice(0, 384), train)
    pq.write_table(tbl.slice(384), evalp)

    def cfg(name):
        text = deepfm_config_text(
            batch_size=64, num_steps=6, model_dir=os.path.join(root, name),
            train_extra="  log_step_count_steps: 2\n"
                        '  tensorboard_summaries: "loss"\n'
                        '  tensorboard_summaries: "learning_rate"')
        text = text.replace('train_input_path: "unused"',
                            f'train_input_path: "{train}"').replace(
            'eval_input_path: "unused"', f'eval_input_path: "{evalp}"')
        path = os.path.join(root, f"{name}.config")
        with open(path, "w") as f:
            f.write(text)
        return path, text

    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jcfg, text = cfg("jax")
    jax_main.train_and_evaluate(jcfg)
    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = os.path.join(root, "init.pt")
    torch.save(converted_state(jmodel, dense, tables, deepfm_table_names()),
               init)
    pcfg, _ = cfg("port")
    port_main.train_and_evaluate(pcfg, fine_tune_checkpoint=init,
                                 device="cpu")
    ours, theirs = (_scalars(os.path.join(root, d)) for d in ("port", "jax"))
    assert set(ours) == set(theirs) == {
        "loss/total_loss", "loss/binary_cross_entropy", "learning_rate",
        "eval/auc", "eval/loss_binary_cross_entropy"}
    for tag, ref in theirs.items():
        got = ours[tag]
        assert [s for s, _ in got] == [s for s, _ in ref], tag
        if tag == "learning_rate":
            assert got == ref
        else:
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in ref], err_msg=tag,
                                       **TOL)
    assert [s for s, _ in ours["loss/total_loss"]] == [2, 4, 6]


def test_summary_writer_without_tensorboard_warns(tmp_path, monkeypatch,
                                                  caplog):
    from torcheasyrec_tpu_torch.utils.summary_util import SummaryWriter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING, logger="tzrec_tpu_torch"):
        tb = SummaryWriter(str(tmp_path / "tb"))
    assert "tensorboard unavailable" in caplog.text
    tb.log_scalars(1, {"total_loss": 1.0}, 0.5)
    tb.log_eval(1, {"auc": 0.5})
    tb.close()
    assert not os.path.exists(tmp_path / "tb")

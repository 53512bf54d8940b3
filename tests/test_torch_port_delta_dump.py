"""F8: the delta embedding dump of the port's training loop against the
JAX package's (CPU, fp32). The port's ``train_and_evaluate`` ignored
``delta_embedding_dump_config`` before."""

import os

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
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config


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


def test_f8_delta_embedding_dump_matches_jax(tmp_path, monkeypatch):
    """Both packages train 5 steps of a small DeepFM from the same
    weights with ``dump_interval_steps: 2``: the same shard names (steps
    2 and 4, and the end, step 5), the same ids, embeddings within 1e-5
    of each shard's max. The port ignored the config before (F8)."""
    train = str(tmp_path / "train.parquet")
    pq.write_table(pa.table(deepfm_cols(200, seed=11)), train)
    evalp = str(tmp_path / "eval.parquet")
    pq.write_table(pa.table(deepfm_cols(64, seed=12)), evalp)
    extra = "  delta_embedding_dump_config { dump_interval_steps: 2 }\n"

    def config(name):
        text = deepfm_config_text(
            32, model_dir=str(tmp_path / name), num_steps=5,
            sparse_opt="adagrad_optimizer { lr: 0.05 }", train_extra=extra)
        text = text.replace('train_input_path: "unused"',
                            f'train_input_path: "{train}"')
        text = text.replace('eval_input_path: "unused"',
                            f'eval_input_path: "{evalp}"')
        path = str(tmp_path / f"{name}.config")
        with open(path, "w") as f:
            f.write(text)
        return path, text

    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_cfg, text = config("jax")
    jax_main.train_and_evaluate(jax_cfg)
    init = str(tmp_path / "init.pt")
    _jax_init_checkpoint(text, init)
    port_cfg, _ = config("port")
    port_main.train_and_evaluate(port_cfg, fine_tune_checkpoint=init,
                                 device="cpu")
    jdir = tmp_path / "jax" / "delta_embedding_dump"
    pdir = tmp_path / "port" / "delta_embedding_dump"
    names = sorted(os.listdir(pdir))
    steps = {int(n.rsplit("-", 1)[1].split(".")[0]) for n in names}
    assert steps == {2, 4, 5}
    # one table a feature, as the JAX dumper keys its ids by feature: the
    # WIDE copies of DeepFM's id features get no shard (ROADMAP §3)
    assert {n.split("-")[1] for n in names} == {
        f"cat_{i}_emb" for i in range(len(deepfm_table_names()) // 2)}
    # both engines merge each feature's WIDE and DEEP tables; the JAX
    # dumper names the shard after the merged table and writes its whole
    # rows, the port names it after the table and writes its columns
    merged = port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu")[0].embedding_group.engine._merged
    assert merged

    def jax_name(name):
        prefix, table, step = name.split("-")
        return "-".join((prefix, merged[table][0], step))

    assert sorted(os.listdir(jdir)) == sorted(jax_name(n) for n in names)
    for name in names:
        got = pq.read_table(pdir / name)
        ref = pq.read_table(jdir / jax_name(name))
        np.testing.assert_array_equal(got["id"].to_numpy(),
                                      ref["id"].to_numpy(), err_msg=name)
        _, c0, width = merged[name.split("-")[1]]
        g = _column(got, "embedding")
        r = _column(ref, "embedding")[:, c0:c0 + width]
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), name

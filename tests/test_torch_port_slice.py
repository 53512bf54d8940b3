"""DLRM-HSTU serving, end to end: the port's predict against the JAX
package's eval step from one config text, one set of Arrow columns and
the JAX weights carried across by utils/convert.py (fp32, CPU)."""

import os

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import (
    converted_state,
    hstu_synth_config_text,
    jax_model_and_state,
    synth_cols,
)
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.main import make_eval_step as jax_eval_step
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.ops import hstu as port_hstu
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

BATCH = 8


@pytest.fixture(scope="module")
def slice_setup():
    text = hstu_synth_config_text(BATCH)
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(text)
    cfg = parse_pipeline_config(text)
    model, features = port_main.build_model(cfg, "cpu")
    state = converted_state(jmodel, dense, tables,
                            list(model.embedding_group.tables.keys()))
    model.load_state_dict(state)
    cols = synth_cols(BATCH, seed=3)
    jbatch = JaxParser(jfeatures).parse_to_batch(cols)
    jpreds, _ = jax_eval_step(jmodel, jnp.float32, with_loss=False)(
        {"dense": dense, "tables": tables}, jbatch
    )
    return text, state, model, features, cols, jpreds


def _assert_preds_match(port_preds, jax_preds):
    keys = [k for k in jax_preds if k.startswith(("probs_", "logits_"))]
    assert len(keys) == 4
    for k in keys:
        np.testing.assert_allclose(
            np.asarray(port_preds[k]), np.asarray(jax_preds[k]),
            rtol=1e-4, atol=1e-5, err_msg=k,
        )


def test_predict_matches_jax_eval_step(slice_setup):
    _, _, model, features, cols, jpreds = slice_setup
    launches = port_hstu.hstu_attention_fwd.launches
    batch = DataParser(features).parse_to_batch(cols)
    preds, _ = port_main.make_eval_step(model, with_loss=False)(batch)
    _assert_preds_match({k: v.numpy() for k, v in preds.items()}, jpreds)
    # CPU tensors take the plain attention: the kernel never launched
    assert port_hstu.hstu_attention_fwd.launches == launches


def test_predict_checkpoint_matches_jax(slice_setup, tmp_path):
    import pyarrow as pa

    text, state, _, _, cols, jpreds = slice_setup
    cfg_path = os.path.join(tmp_path, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text.replace("/tmp/tzrec_bench_model/dlrm_hstu",
                             str(tmp_path / "model")))
    ckpt = os.path.join(tmp_path, "model.pt")
    torch.save(state, ckpt)
    inp = os.path.join(tmp_path, "in.parquet")
    pq.write_table(pa.table(cols), inp)
    out = os.path.join(tmp_path, "out.parquet")
    n = port_main.predict_checkpoint(
        cfg_path, inp, out, checkpoint_path=ckpt,
        reserved_columns="user_id", batch_size=BATCH // 2, device="cpu",
    )
    assert n == BATCH
    table = pq.read_table(out)
    np.testing.assert_array_equal(table["user_id"].to_numpy(),
                                  cols["user_id"].to_numpy())
    got = {
        k: np.stack(table[k].to_numpy(zero_copy_only=False))
        for k in table.column_names if k != "user_id"
    }
    _assert_preds_match(got, jpreds)


def test_entry_points_raise_without_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = parse_pipeline_config(hstu_synth_config_text(BATCH))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.predict_checkpoint("never-read.config", "in", "out")

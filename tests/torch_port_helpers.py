"""Shared helpers of the torcheasyrec_tpu_torch parity tests: one config
text and one set of Arrow columns fed to both packages."""

import numpy as np
import pyarrow as pa
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CONFIG_PATH = "torcheasyrec_tpu/benchmark/configs/hstu_synth/dlrm_hstu.config"
N_USERS, VOCAB, MAX_SEQ, N_CAND = 2000, 5000, 32, 10


def hstu_synth_config_text(batch_size: int = 8, kernel: str = "") -> str:
    """The hstu_synth DLRM-HSTU config (E=128, 32-dim heads, 3 layers,
    seq 32) at ``batch_size``, optionally with ``model_config.kernel``."""
    with open(CONFIG_PATH) as f:
        text = f.read()
    text = text.replace("batch_size: 128", f"batch_size: {batch_size}")
    if kernel:
        text = text.replace("model_config {", f"model_config {{\n  kernel: {kernel}", 1)
    return text


def synth_cols(n: int, seed: int, min_len: int = 1, max_len: int = MAX_SEQ):
    """Kuairand-shaped Arrow columns at the hstu_synth widths, in the
    shape of benchmark/bench_dlrm_hstu._synth_cols."""
    r = np.random.default_rng(seed)
    cols = {
        "user_id": pa.array(r.integers(0, N_USERS, n)),
        "unused_label": pa.array(np.zeros(n, np.float32)),
    }
    lens = r.integers(min_len, max_len + 1, n)
    hists, acts, tss = [], [], []
    for lu in lens:
        hists.append(";".join(map(str, r.integers(0, VOCAB, lu))))
        acts.append(";".join(map(str, r.integers(0, 4, lu))))
        tss.append(";".join(map(str, np.sort(r.integers(0, 10**6, lu)))))
    cands, qts, ws = [], [], []
    for _ in range(n):
        lc = int(r.integers(1, N_CAND + 1))
        cands.append(";".join(map(str, r.integers(0, VOCAB, lc))))
        qts.append(";".join(["1000000"] * lc))
        ws.append(";".join(map(str, r.integers(0, 4, lc))))
    cols["video_id"] = pa.array(hists)
    cols["action_weight"] = pa.array(acts)
    cols["action_timestamp"] = pa.array(tss)
    cols["item_video_id"] = pa.array(cands)
    cols["item_query_time"] = pa.array(qts)
    cols["item_action_weight"] = pa.array(ws)
    return cols


def jax_model_and_state(cfg_text: str):
    """(JAX pipeline config, model, dense params, tables) from one text."""
    from google.protobuf import text_format

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.protos import pipeline_pb2

    cfg = text_format.Parse(cfg_text, pipeline_pb2.EasyRecConfig())
    model, features, _ = jax_main._build_model_and_optim(cfg, None)
    dense, tables, _ = jax_main._init_state(model, cfg)
    return cfg, model, features, dense, tables


def converted_state(jax_model, dense, tables, table_names):
    """The JAX model's weights as a torch state_dict."""
    import jax

    from torcheasyrec_tpu_torch.utils.convert import from_jax_state

    eng = jax_model.embedding_group.engine
    canon = {
        name: np.asarray(eng.extract_table(tables, name))
        for name in table_names
    }
    return from_jax_state(jax.device_get(dense), canon)


def hstu_synth_train_config_text(batch_size: int = 4, num_layers: int = 2,
                                 stu_extra: str = "", kernel: str = "",
                                 input_dropout: float = 0.0) -> str:
    """The hstu_synth config cut to ``num_layers`` STU layers for the
    training tests, with the input dropout set explicitly (the proto's
    default is 0.2) and ``stu_extra`` spliced into the STU block."""
    text = hstu_synth_config_text(batch_size, kernel)
    text = text.replace("num_layers: 3", f"num_layers: {num_layers}\n{stu_extra}")
    assert "    hstu {" in text
    return text.replace(
        "    hstu {", f"    hstu {{\n input_dropout_ratio: {input_dropout}", 1)


def jax_train_setup(cfg_text: str):
    """(cfg, model, features, state, jitted train step) of the JAX
    package in fp32; the state holds dense, tables, sparse_opt,
    dense_opt and step."""
    import jax
    import jax.numpy as jnp
    from google.protobuf import text_format

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.optim.optimizer_builder import (
        create_dense_optimizer,
    )
    from torcheasyrec_tpu.protos import pipeline_pb2

    cfg = text_format.Parse(cfg_text, pipeline_pb2.EasyRecConfig())
    model, features, sparse_sched = jax_main._build_model_and_optim(cfg, None)
    dense, tables, sparse_opt = jax_main._init_state(model, cfg)
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, dense)
    state = {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
             "dense_opt": tx.init(dense), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jax_main.make_train_step(
        model, tx, sparse_sched, dense_sched, jnp.float32))
    return cfg, model, features, state, step

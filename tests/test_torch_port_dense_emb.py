"""Dense embeddings on raw features and vocab-file tables of the port
against the JAX package (fp32, CPU; the JAX weights cross through
utils/convert.py).

- ``AutoDisEmbedding`` (one value column, and three: one embedding per
  column, concatenated) and ``MLPEmbedding``: the output within 1e-5 of
  its max, the gradients of the parameters and of the input within 1e-4
  of each one's max.
- A DeepFM whose ``int_0`` is embedded by AutoDis, ``int_1`` by an MLP
  embedding and whose ``cat_2`` table is sized by a vocab file (explicit
  indices, the OOV slot): the groups' dims and the table sizes equal the
  JAX model's, every dense parameter under its JAX path, a strict load of
  the converted weights; 3 train steps with the losses, dense parameters
  (the dense embeddings' included), tables and row state within 1e-4
  of each tensor's max.
- ``vocab_file`` sizes: plain lines, "token index" lines, blank lines
  and a ``default_bucketize_value`` past the file, equal to the JAX
  feature's ``num_embeddings``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import (
    PairedTrainers,
    assert_close_to_max,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
)
from torcheasyrec_tpu.features import create_features as jax_features
from torcheasyrec_tpu.modules import embedding as jax_embedding
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.optim import optimizer_builder as jax_builder
from torcheasyrec_tpu.protos import feature_pb2 as jax_feature_pb2
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.modules import embedding as port_embedding
from torcheasyrec_tpu_torch.protos import feature_pb2
from torcheasyrec_tpu_torch.utils import convert

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
LABELS = ["label"]


def _module_pair(kind: str, vd: int):
    """(JAX module, its params, the port's module holding them)."""
    key = jax.random.PRNGKey(7)
    if kind == "autodis":
        jmod = jax_embedding.AutoDisEmbedding(5, 4, temperature=0.3,
                                              keep_prob=0.7)
        mod = port_embedding.AutoDisEmbedding(5, 4, torch.Generator(),
                                              temperature=0.3, keep_prob=0.7)
    else:
        jmod = jax_embedding.MLPEmbedding(vd, 4)
        mod = port_embedding.MLPEmbedding(vd, 4, torch.Generator())
    params = jmod.init(key)
    mod.load_state_dict(convert.from_jax_state(jax.device_get(params), {}))
    return jmod, params, mod


@pytest.mark.parametrize("kind,vd", [("autodis", 1), ("autodis", 3),
                                     ("mlp", 1), ("mlp", 3)])
def test_dense_embedding_module_matches_jax(kind, vd):
    x = np.random.default_rng(2).normal(size=(32, vd)).astype(np.float32)
    w = np.random.default_rng(3).normal(
        size=(32, 4 * (vd if kind == "autodis" else 1))).astype(np.float32)
    jmod, params, mod = _module_pair(kind, vd)
    ctx = JM.Context(training=True, rng=jax.random.PRNGKey(0),
                     compute_dtype=jnp.float32)

    def jfn(p, xx):
        out = jmod(p, xx, ctx)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1),
                                               has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt, torch.float32)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == jout.shape
    assert_close_to_max(out.detach().numpy(), np.asarray(jout), "out",
                        FWD_TOL)
    assert_close_to_max(xt.grad.numpy(), np.asarray(jgx), "grad x", GRAD_TOL)
    ref = convert.from_jax_state(jax.device_get(jgp), {})
    for n, p in mod.named_parameters():
        assert_close_to_max(p.grad.numpy(), ref[n].numpy(), f"grad {n}",
                            GRAD_TOL)


# --- vocab files ---------------------------------------------------------------


@pytest.mark.parametrize("lines,dbv", [
    (["a", "b", "", "c"], None),
    (["a 3", "b 9", "c 4"], None),
    (["a", "b"], 6),
    ([], None),
])
def test_vocab_file_size_matches_jax(tmp_path, lines, dbv):
    path = str(tmp_path / "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    extra = f" default_bucketize_value: {dbv}" if dbv is not None else ""
    text = (f'id_feature {{ feature_name: "c" vocab_file: "{path}" '
            f"embedding_dim: 4{extra} }}")
    ours = create_features([text_format.Parse(
        text, feature_pb2.FeatureConfig())])[0]
    ref = jax_features([text_format.Parse(
        text, jax_feature_pb2.FeatureConfig())])[0]
    assert ours.num_embeddings == ref.num_embeddings
    assert ours.emb_config().num_embeddings == ref.num_embeddings


# --- DeepFM with dense embeddings and a vocab-file table ------------------------


def dense_emb_deepfm_text(vocab_path: str) -> str:
    text = deepfm_config_text(64)
    text = text.replace(
        'raw_feature { feature_name: "int_0" }',
        'raw_feature { feature_name: "int_0" embedding_dim: 8 autodis { '
        "num_channels: 6 temperature: 0.5 keep_prob: 0.6 } }").replace(
        'raw_feature { feature_name: "int_1" }',
        'raw_feature { feature_name: "int_1" embedding_dim: 8 mlp {} }')
    old = 'id_feature { feature_name: "cat_2" num_buckets: 7 '
    assert old in text
    return text.replace(old, 'id_feature { feature_name: "cat_2" '
                        f'vocab_file: "{vocab_path}" ')


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense_emb")
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        # 7 ids, one at an explicit index: the table has 9 rows
        f.write("a\nb\nc\nd\ne\nf\ng 8\n")
    text = dense_emb_deepfm_text(vocab)
    t = PairedTrainers(text, deepfm_table_names(), LABELS)
    losses = []
    for i in range(3):
        jm, m = t.step(deepfm_cols(64, seed=60 + i))
        losses.append((float(jm["total_loss"]), float(m["total_loss"])))
    return t, losses


def test_dense_emb_deepfm_builds_as_jax(paired):
    t, _ = paired
    eg, jeg = t.model.embedding_group, t.jmodel.embedding_group
    for g in eg.group_names():
        assert eg.group_dims(g) == jeg.group_dims(g), g
    assert eg.group_dims("deep")[-3:] == [8, 8, 1]
    assert sorted(eg.dense_emb) == ["int_0", "int_1"]
    assert type(eg.dense_emb["int_0"]).__name__ == "AutoDisEmbedding"
    assert eg.tables["cat_2_emb"].shape[0] == 9
    jdense = jax.device_get(t.jstate["dense"])
    assert sorted(convert.dense_param_paths(t.model).values()) == sorted(
        jax_builder._param_paths(jdense))
    assert "embedding_group/dense_emb/int_0/w2" in set(
        convert.dense_param_paths(t.model).values())


def test_dense_emb_deepfm_three_steps_match_jax(paired):
    t, losses = paired
    for jl, pl in losses:
        assert_close_to_max(pl, jl, "total_loss", STEP_TOL)
    t.assert_close(STEP_TOL)

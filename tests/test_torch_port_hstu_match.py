"""HSTU-Match of the port against the JAX package: grouped sequence
features, candidate labels named ``{sequence}__{column}``, the negative
sampler in sequence mode, the UIH preprocessor with an action encoder
and the request-time anchor; the jagged and the scalar candidate modes.
The four cases of tests/test_hstu_match.py on the port, and the model
held against the JAX one from the same weights and batches (fp32, CPU):
forward and loss within 1e-5 of each output's max, dense gradients within
1e-4, one optimizer step (adam at eps 1e-4, as in test_torch_port_gr.py)
within 1e-4 for the dense parameters and 1e-3 for the tables and row
state."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from test_hstu_match import CONFIG, _gen_data
from torch_port_helpers import (
    PairedTrainers,
    assert_close_to_max,
    assert_forward_and_grads_match,
    converted_state,
    jax_model_and_state,
)
from torcheasyrec_tpu.datasets import sampler as jax_sampler
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.features import create_features as jax_create_features
from torcheasyrec_tpu.protos import feature_pb2 as jfeature_pb2
from torcheasyrec_tpu.protos import sampler_pb2 as jsampler_pb2
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.datasets.dataset import create_sampler
from torcheasyrec_tpu_torch.datasets.sampler import NegativeSampler
from torcheasyrec_tpu_torch.features.feature import create_features
from torcheasyrec_tpu_torch.models.hstu_match import HSTUMatch
from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2, sampler_pb2
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

BATCH = 32
LABELS = ["cand_seq__action_weight"]
TABLES = ["user_id_emb", "user_degree_emb", "video_emb"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hstu_match"))
    train, evalp, item = _gen_data(root)
    return root, train, evalp, item


def _text(data, dropout=0.1, scalar=False):
    root, train, evalp, item = data
    text = CONFIG.format(train=train, eval=evalp,
                         model_dir=os.path.join(root, "model"),
                         item_table=item)
    text = text.replace("input_dropout_ratio: 0.1",
                        f"input_dropout_ratio: {dropout}")
    if scalar:
        # one positive a row in a DEEP item group, in-batch negatives
        text = text.replace(
            'feature_configs {\n    raw_feature { feature_name: "request_time"',
            'feature_configs {\n    id_feature { feature_name: "cand_item"'
            ' expression: "item:video_id" embedding_name: "video_emb"'
            ' num_buckets: 256 embedding_dim: 32 }\n}\n'
            'feature_configs {\n    raw_feature { feature_name: "request_time"')
        text = text.replace(
            'feature_names: "cand_seq__video_id"\n        group_type: '
            'JAGGED_SEQUENCE', 'feature_names: "cand_item"\n        '
            'group_type: DEEP')
        text = text.replace("similarity: COSINE",
                            "similarity: COSINE\n        in_batch_negative: true")
        text = text.replace(
            "    negative_sampler {\n        input_path: \"" + data[3] + "\"\n"
            "        num_sample: 32\n        attr_fields: \"cand_seq__video_id\"\n"
            "        item_id_field: \"cand_seq__video_id\"\n    }\n", "")
        assert "negative_sampler" not in text
    return text


def _rows(path, n, offset=0):
    tbl = pq.read_table(path).slice(offset, n)
    cols = {k: tbl.column(k).combine_chunks() for k in tbl.column_names}
    cols["cand_item"] = pa.array([int(s.split(";")[0]) for s in
                                  cols["cand_seq__video_id"].to_pylist()])
    return cols


def _samplers(text):
    """The JAX package's and the port's samplers of the config."""
    from torcheasyrec_tpu.protos import pipeline_pb2 as jpipeline_pb2

    cfg = parse_pipeline_config(text)
    jcfg = jpipeline_pb2.EasyRecConfig.FromString(cfg.SerializeToString())
    _, features, _ = port_main._build_model_and_optim(cfg, "cpu")
    js = jax_sampler.NegativeSampler(
        jcfg.data_config.negative_sampler, batch_size=BATCH, seq_delim=";")
    return js, create_sampler(cfg.data_config, "train", features)


# -- the four cases of tests/test_hstu_match.py ---------------------------------


def test_hstu_match_jagged_end_to_end(data):
    """``train_and_evaluate`` through the loader (sampler in sequence
    mode, jagged labels), with the JAX test's data, config and bounds:
    random recall@1 over 32 negatives is about 1/33 and recall@5 0.15."""
    root = data[0]
    cfg_path = os.path.join(root, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(_text(data))
    result = port_main.train_and_evaluate(cfg_path, device="cpu")
    assert result["recall@1"] > 0.10, result
    assert result["recall@5"] > 0.30, result
    assert np.isfinite(result["loss_softmax_cross_entropy"])


def test_hstu_match_rejects_in_batch_negative_with_jagged_candidates():
    feat_cfgs = [text_format.Parse(t, feature_pb2.FeatureConfig()) for t in (
        """sequence_feature { sequence_name: 'uih_seq' sequence_length: 8
            sequence_delim: ';' features { id_feature { feature_name: 'vid'
            num_buckets: 32 embedding_dim: 16 } } }""",
        """sequence_feature { sequence_name: 'cand_seq' sequence_length: 4
            sequence_delim: ';' features { id_feature { feature_name: 'vid'
            num_buckets: 32 embedding_dim: 16 } } }""")]
    mc = text_format.Parse("""
        feature_groups { group_name: 'uih'
            feature_names: 'uih_seq__vid' group_type: JAGGED_SEQUENCE }
        feature_groups { group_name: 'candidate'
            feature_names: 'cand_seq__vid' group_type: JAGGED_SEQUENCE }
        hstu_match {
            user_tower { input: 'uih'
                hstu { stu { embedding_dim: 16 hidden_dim: 8
                             attention_dim: 8 num_heads: 1
                             num_layers: 1 } }
                max_seq_len: 8 }
            item_tower { input: 'candidate' }
            in_batch_negative: true }""", model_pb2.ModelConfig())
    with pytest.raises(ValueError, match="in_batch_negative"):
        HSTUMatch(mc, create_features(feat_cfgs), labels=["l"])


def test_jagged_label_parse():
    """Label fields named {sequence}__{column} parse as padded [B, L],
    keeping the last steps, as the JAX parser does; a list-valued label
    too."""
    text = """sequence_feature {
        sequence_name: 'cand_seq' sequence_length: 4 sequence_delim: ';'
        features { id_feature { feature_name: 'vid'
            num_buckets: 32 embedding_dim: 8 } } }"""
    features = create_features(
        [text_format.Parse(text, feature_pb2.FeatureConfig())])
    jfeatures = jax_create_features(
        [text_format.Parse(text, jfeature_pb2.FeatureConfig())])
    assert [f.name for f in features] == [f.name for f in jfeatures] == [
        "cand_seq__vid"]
    cols = {
        "cand_seq__vid": pa.array(["1;2;3", "4", "5;6;7;8;9"]),
        "cand_seq__aw": pa.array(["1;0;1", "1", "0;1;1;0;1"]),
        "listed": pa.array([[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]]),
    }
    labels = ["cand_seq__aw", "listed"]
    batch = DataParser(features, labels=labels).parse_to_batch(cols)
    jbatch = JaxParser(jfeatures, labels=labels).parse_to_batch(cols)
    lab = batch.labels["cand_seq__aw"].numpy()
    assert lab.shape == (3, 4)
    np.testing.assert_array_equal(lab[2], [1, 1, 0, 1])
    np.testing.assert_array_equal(lab[1], [1, 0, 0, 0])
    for k in labels:
        np.testing.assert_array_equal(batch.labels[k].numpy(),
                                      np.asarray(jbatch.labels[k]))
    ids = batch.sequence_sparse_features["cand_seq__vid"]
    jids = jbatch.sequence_sparse_features["cand_seq__vid"]
    np.testing.assert_array_equal(ids.values.numpy(), np.asarray(jids.values))
    np.testing.assert_array_equal(ids.lengths.numpy(),
                                  np.asarray(jids.lengths))


def test_sampler_flattens_sequence_positives(tmp_path):
    """The sampler in sequence mode takes every id of multi-positive rows
    as a positive (drawn again, twice at most) and appends its negatives
    as one-item rows, the same ones as the JAX sampler."""
    items = pa.table({"id": pa.array(np.arange(8)),
                      "weight": pa.array(np.ones(8)),
                      "attrs": pa.array([str(i) for i in range(8)])})
    path = os.path.join(str(tmp_path), "items.parquet")
    pq.write_table(items, path)
    kw = dict(input_path=path, num_sample=4, attr_fields=["cand_seq__vid"],
              item_id_field="cand_seq__vid")
    s = NegativeSampler(sampler_pb2.NegativeSampler(**kw), seq_delim=";")
    js = jax_sampler.NegativeSampler(jsampler_pb2.NegativeSampler(**kw),
                                     batch_size=2, seq_delim=";")
    cols = {"cand_seq__vid": pa.array(["0;1;2", "3;4"])}
    assert s._pos_id_set(cols) == js._pos_id_set(cols) == {0, 1, 2, 3, 4}
    out, jout = s.process(dict(cols)), js.process(dict(cols))
    assert len(out["cand_seq__vid"]) == 6
    assert out["cand_seq__vid"].equals(jout["cand_seq__vid"])


# -- the model against the JAX one ----------------------------------------------


def _pair_setup(text):
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(text)
    model, features, _ = port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu", for_train=True)
    model.load_state_dict(converted_state(jmodel, dense, tables, TABLES))
    return jmodel, jfeatures, dense, tables, model, features


@pytest.mark.parametrize("mode", ["jagged", "scalar"])
def test_hstu_match_forward_gradients_and_step_match_jax(data, mode):
    scalar = mode == "scalar"
    text = _text(data, dropout=0.0, scalar=scalar)
    jmodel, jfeatures, dense, tables, model, features = _pair_setup(text)
    assert type(model).__name__ == type(jmodel).__name__ == "HSTUMatch"
    assert model.tower_specs() == jmodel.tower_specs()
    assert model._jagged_items is not scalar
    cols = _rows(data[1], BATCH)
    if not scalar:
        js, ps = _samplers(text)
        jcols, cols = js.process(dict(cols)), ps.process(dict(cols))
        for k in jcols:
            assert cols[k].equals(jcols[k]), k
    jbatch = JaxParser(jfeatures, labels=LABELS).parse_to_batch(cols)
    batch = DataParser(features, labels=LABELS).parse_to_batch(cols)
    preds = assert_forward_and_grads_match(model, batch, jmodel, dense,
                                           tables, jbatch)
    if scalar:
        assert tuple(preds["similarity"].shape) == (BATCH, BATCH)
    else:
        n_rows = int(preds["similarity_mask"].sum())
        assert tuple(preds["similarity"].shape) == (BATCH * 4, 1 + 32)
        assert n_rows == int(batch.sequence_sparse_features[
            "cand_seq__video_id"].lengths[:BATCH].sum())
    # metrics over the real positives, equal to the JAX model's
    jm, m = jmodel.init_metrics(), model.init_metrics()
    jpreds = {k: np.asarray(v) for k, v in jax_forward(
        jmodel, dense, tables, jbatch).items()}
    jmodel.update_metrics(jm, jpreds, jbatch)
    model.update_metrics(m, {k: v.detach() for k, v in preds.items()}, batch)
    want, got = jmodel.compute_metrics(jm), model.compute_metrics(m)
    assert list(got) == list(want) == ["recall@1", "recall@5"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    # each tower alone gives the forward's embeddings
    model.eval()
    grouped = model.embedding_group(batch, torch.float32)
    for tower in ("user", "item"):
        emb = model.predict_tower(grouped, batch, tower)
        torch.testing.assert_close(emb, preds[f"{tower}_tower_emb"].detach(),
                                   rtol=1e-6, atol=1e-6)
    model.train()

    step_text = text.replace("adam_optimizer { lr: 0.01 }",
                             "adam_optimizer { lr: 0.01 eps: 1e-4 }")
    pair = PairedTrainers(step_text, TABLES, LABELS)
    jmetrics, metrics = pair.step(cols)
    assert_close_to_max(float(metrics["softmax_cross_entropy"]),
                        float(jmetrics["softmax_cross_entropy"]), "loss",
                        1e-5)
    pair.assert_close(1e-4, table_tol=1e-3)


def jax_forward(jmodel, dense, tables, jbatch):
    """The JAX model's training-mode predictions (dropout ratios 0)."""
    from torch_port_helpers import jax_train_loss

    return jax_train_loss(jmodel, tables, jbatch)(dense)[1]

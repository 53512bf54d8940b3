"""The port's last four tools and the ODPS stub, on the CPU, against the
JAX package's:

- ``tools/convert_easyrec_config.py``: the converted text and the
  warnings equal the JAX converter's for every golden family of
  tests/test_config_converter.py, its DSSM, MMoE-with-decay and DeepFM
  sources and its fg.json case; each converted DeepFM config trains 2
  steps in the port (with ``sparse_dist_overlap`` set, whose warning the
  port gives once: the step runs unpipelined);
- ``tools/add_feature_info_to_config.py`` writes the JAX tool's config;
- ``tools/list_ckpt_param.py`` lists every tensor of a saved checkpoint
  (the model, the optimizer states, the ZCH mappings and ``zch_spill``)
  with its shape and dtype;
- ``tools/create_faiss_index.py`` writes the JAX tool's brute-force
  index, array for array (faiss is on neither machine);
- ``datasets/odps_dataset.py``: the three classes raise with the advice
  to export to Parquet.
"""

import logging
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import test_config_converter as golden
from torcheasyrec_tpu.tools import add_feature_info_to_config as jax_afi
from torcheasyrec_tpu.tools import convert_easyrec_config as jax_conv
from torcheasyrec_tpu.tools import create_faiss_index as jax_faiss
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets import dataset as port_dataset
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.tools import add_feature_info_to_config as afi
from torcheasyrec_tpu_torch.tools import convert_easyrec_config as conv
from torcheasyrec_tpu_torch.tools import create_faiss_index
from torcheasyrec_tpu_torch.tools import list_ckpt_param
from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util
from torcheasyrec_tpu_torch.utils.test_util import write_mock_parquet

from torch_port_helpers import zch_deepfm_config_text

FG_JSON = {"features": [
    {"feature_type": "id_feature", "feature_name": "user_id",
     "expression": "user:user_id", "hash_bucket_size": 1000,
     "embedding_dim": 16, "default_value": "-1"},
    {"feature_type": "raw_feature", "feature_name": "price",
     "expression": "item:price",
     "normalizer": "method=log10,threshold=1e-10,default=-10"},
    {"feature_type": "lookup_feature", "feature_name": "kv",
     "map": "user:kv_map", "key": "item:kv_key"},
    {"feature_type": "match_feature", "feature_name": "m",
     "user": "user:m_map", "category": "item:cate", "item": "item:iid"},
    {"sequence_name": "click_seq", "sequence_length": 40,
     "sequence_delim": ";", "features": [
         {"feature_type": "id_feature", "feature_name": "iid",
          "expression": "item:iid", "hash_bucket_size": 2000,
          "embedding_dim": 16},
         {"feature_type": "raw_feature", "feature_name": "ts",
          "expression": "item:ts"},
     ]},
]}
FG_SRC = """
model_config {
  model_class: "DSSM"
  feature_groups { group_name: "user" feature_names: "user_id"
                   wide_deep: DEEP }
  feature_groups { group_name: "item" feature_names: "price"
                   wide_deep: DEEP }
  dssm {
    user_tower { id: "user" dnn { hidden_units: [128, 32] } }
    item_tower { id: "item" dnn { hidden_units: [128, 32] } }
    temperature: 0.2
  }
}
data_config { batch_size: 256 label_fields: "clk" }
"""
DSSM_SRC = golden._TF_HEAD + golden._TF_FEATURES + """
model_config {
  feature_groups { group_name: "user" feature_names: "uid"
                   feature_names: "tags" wide_deep: DEEP }
  feature_groups { group_name: "item" feature_names: "iid"
                   feature_names: "price" wide_deep: DEEP }
  model_class: "DSSM"
  dssm {
    user_tower { id: "user" dnn { hidden_units: [32, 16] } }
    item_tower { id: "item" dnn { hidden_units: [32, 16] } }
    temperature: 0.2
  }
}
"""
MMOE_SRC = """
train_config {
  optimizer_config {
    adagrad_optimizer { learning_rate { exponential_decay_learning_rate {
      initial_learning_rate: 0.05 decay_steps: 2000 decay_factor: 0.7
      min_learning_rate: 0.0001 } } }
  }
  num_steps: 100
  sync_replicas: false
}
data_config { batch_size: 512 }
feature_config {
  features { input_names: "uid" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 100 }
  features { input_names: "tags" feature_type: TagFeature
             embedding_dim: 8 hash_bucket_size: 50 kv_separator: ":" }
  features { input_names: "hist" feature_type: SequenceFeature
             sub_feature_type: IdFeature sequence_length: 30
             embedding_dim: 8 hash_bucket_size: 100 }
}
model_config {
  model_class: "MMoE"
  feature_groups { group_name: "all" feature_names: "uid"
                   feature_names: "tags" wide_deep: DEEP }
  mmoe {
    expert_dnn { hidden_units: [256, 128] }
    num_expert: 3
    task_towers { tower_name: "ctr" label_name: "clk"
                  dnn { hidden_units: [64] } }
    task_towers { tower_name: "cvr" label_name: "buy"
                  dnn { hidden_units: [32] } }
  }
  embedding_regularization: 1e-5
}
"""
# name -> (TF-EasyRec text, fg.json or None)
SOURCES = dict(
    {f"golden_{k}": (golden._TF_HEAD + golden._TF_FEATURES
                     + "model_config {\n" + v + "}\n", None)
     for k, v in golden._FAMILY_CONFIGS.items()},
    deepfm=(golden.TF_EASYREC_CONFIG, None), dssm=(DSSM_SRC, None),
    mmoe_decay=(MMOE_SRC, None), fg_json=(FG_SRC, FG_JSON))
DEEPFM_SOURCES = ("deepfm", "golden_DeepFM")


@pytest.mark.parametrize("name", list(SOURCES))
def test_converter_matches_jax(name, tmp_path, caplog):
    text, fg = SOURCES[name]
    ours, warns = conv.convert(text, fg)
    theirs, jwarns = jax_conv.convert(text, fg)
    assert ours == theirs
    assert warns == jwarns
    cfg = config_util.parse_pipeline_config(ours)
    assert cfg.model_config.WhichOneof("model") is not None
    if name == "mmoe_decay":
        assert any("sync_replicas" in w for w in warns)
    if name not in DEEPFM_SOURCES:
        return
    assert any("'fm' group" in w for w in warns)
    # the converted DeepFM trains 2 steps in the port
    root = str(tmp_path)
    cfg.train_input_path = os.path.join(root, "train.parquet")
    cfg.eval_input_path = os.path.join(root, "eval.parquet")
    cfg.model_dir = os.path.join(root, "model")
    cfg.data_config.batch_size = 64
    cfg.train_config.num_steps = 2
    cfg.train_config.use_tensorboard = False
    cfg.train_config.sparse_dist_overlap = True
    features = create_features(list(cfg.feature_configs))
    labels = list(cfg.data_config.label_fields)
    write_mock_parquet(cfg.train_input_path, features, 256, labels, seed=0)
    write_mock_parquet(cfg.eval_input_path, features, 128, labels, seed=1)
    path = os.path.join(root, "converted.config")
    config_util.save_message(cfg, path)
    with caplog.at_level(logging.WARNING, logger="tzrec_tpu_torch"):
        result = port_main.train_and_evaluate(path, device="cpu")
    assert result["step"] == 2.0
    assert all(np.isfinite(v) for v in result.values()), result
    said = [r.getMessage() for r in caplog.records
            if "sparse_dist_overlap" in r.getMessage()]
    assert len(said) == 1 and "unpipelined" in said[0], said


def test_add_feature_info_matches_jax(tmp_path):
    r = np.random.default_rng(3)
    data = str(tmp_path / "data.parquet")
    pq.write_table(pa.table({
        "uid": r.integers(0, 500, 1000), "name": pa.array(
            [f"n{i}" for i in r.integers(0, 40, 1000)]),
        "price": r.normal(size=1000).astype(np.float32),
        "label": r.integers(0, 2, 1000).astype(np.float32)}), data)
    src = str(tmp_path / "src.config")
    with open(src, "w") as f:
        f.write(f"""train_input_path: "{data}"
data_config {{ batch_size: 32 label_fields: "label" }}
feature_configs {{ id_feature {{ feature_name: "uid" embedding_dim: 8 }} }}
feature_configs {{ id_feature {{ feature_name: "name" embedding_dim: 8 }} }}
feature_configs {{ raw_feature {{ feature_name: "price" }} }}
""")
    ours, theirs = str(tmp_path / "ours.config"), str(tmp_path / "j.config")
    afi.add_feature_info(src, ours, sample_rows=800, num_boundaries=5)
    jax_afi.add_feature_info(src, theirs, sample_rows=800, num_boundaries=5)
    assert open(ours).read() == open(theirs).read()
    cfg = config_util.load_pipeline_config(ours)
    by = {getattr(f, f.WhichOneof("feature")).feature_name: f
          for f in cfg.feature_configs}
    assert by["uid"].id_feature.num_buckets > 0
    assert by["name"].id_feature.hash_bucket_size > 0
    assert len(by["price"].raw_feature.boundaries) == 5


def _flatten(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(node, torch.Tensor):
        yield prefix, tuple(node.shape), str(node.dtype).split(".")[-1]


def test_list_ckpt_param_covers_every_tensor(tmp_path):
    cfg = config_util.parse_pipeline_config(
        zch_deepfm_config_text(batch_size=16))
    model, _, _ = port_main._build_model_and_optim(cfg, "cpu")
    tx, _ = port_main._dense_optimizer(model, cfg.train_config)
    state = port_main._init_state(model, tx)
    path = checkpoint_util.save_checkpoint(str(tmp_path), model, tx, state)
    listed = list_ckpt_param.list_params(path)
    want = list(_flatten(torch.load(path, weights_only=True)))
    assert listed == want
    paths = [p for p, _, _ in listed]
    assert any(p.startswith("model/embedding_group.zch.") for p in paths)
    assert any(p.startswith("zch_spill/cat_4_emb/") for p in paths)
    assert any(p.startswith("sparse_opt/") for p in paths)
    assert any(p.startswith("dense_opt/") for p in paths)
    # a model dir lists its latest checkpoint
    assert list_ckpt_param.list_params(str(tmp_path)) == listed


def test_bruteforce_index_matches_jax(tmp_path):
    r = np.random.default_rng(5)
    emb = str(tmp_path / "items.parquet")
    pq.write_table(pa.table({
        "item": r.permutation(300).astype(np.int64),
        "vec": pa.array(list(r.normal(size=(300, 12)).astype(np.float32)))}),
        emb)
    ours = create_faiss_index.build_index(emb, str(tmp_path / "ours"),
                                          id_column="item",
                                          embedding_column="vec")
    theirs = jax_faiss.build_index(emb, str(tmp_path / "jax"),
                                   id_column="item", embedding_column="vec")
    assert os.path.basename(ours) == "bruteforce_index.npz"
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files) == ["embeddings", "ids"]
    for k in b.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("what", ["OdpsDataset", "OdpsDatasetV1",
                                  "OdpsWriter"])
def test_odps_stub_raises(what):
    from torcheasyrec_tpu_torch.protos import data_pb2

    with pytest.raises(NotImplementedError, match="Parquet"):
        if what == "OdpsWriter":
            port_dataset.create_writer("odps://p/t", "OdpsWriter")
        else:
            port_dataset.create_reader(
                "odps://p/t", 8,
                dataset_type=data_pb2.DatasetType.Value(what))

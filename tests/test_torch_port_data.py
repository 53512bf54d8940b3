"""Data and embedding path of the port against the JAX package: the same
Arrow columns through both DataParsers (ids, lengths and dense values
exactly equal), then both EmbeddingGroups under the same tables."""

import numpy as np
import pyarrow as pa
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import hstu_synth_config_text, synth_cols
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.features import create_features as jax_features
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules.embedding import EmbeddingGroup as JaxGroup
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

# id, raw, multi-valued, weighted-free pooled and multi-value-step
# sequence features beside the DLRM-HSTU ones
EXTRA = """
feature_configs { id_feature { feature_name: "tags" num_buckets: 50
                               embedding_dim: 8 pooling: "mean" } }
feature_configs { raw_feature { feature_name: "price" } }
feature_configs { sequence_id_feature { feature_name: "seq_tags"
    num_buckets: 50 embedding_dim: 8 sequence_length: 6
    embedding_name: "tags_emb" } }
model_config {
  feature_groups { group_name: "deep" feature_names: "user_id"
                   feature_names: "tags" feature_names: "price"
                   group_type: DEEP }
  feature_groups { group_name: "seq" feature_names: "seq_tags"
                   feature_names: "user_id" group_type: SEQUENCE }
}
"""


def _extra_cols(n, seed):
    r = np.random.default_rng(seed)
    sep = chr(3)
    tags = [sep.join(map(str, r.integers(0, 60, int(r.integers(0, 4)))))
            for _ in range(n)]
    seq_tags = [
        ";".join(sep.join(map(str, r.integers(0, 50, int(r.integers(1, 3)))))
                 for _ in range(int(r.integers(1, 9))))
        for _ in range(n)
    ]
    return {"tags": pa.array(tags),
            "price": pa.array(r.normal(size=n).astype(np.float32)),
            "seq_tags": pa.array(seq_tags)}


def _both(text):
    jcfg = text_format.Merge(text, jax_pb2.EasyRecConfig())
    pcfg = parse_pipeline_config(text)
    jf = jax_features(list(jcfg.feature_configs),
                      fg_mode=jcfg.data_config.fg_mode)
    pf = create_features(list(pcfg.feature_configs),
                         fg_mode=pcfg.data_config.fg_mode)
    return jcfg, pcfg, jf, pf


@pytest.fixture(scope="module")
def parsed():
    text = hstu_synth_config_text(6) + EXTRA
    jcfg, pcfg, jf, pf = _both(text)
    cols = {**synth_cols(6, seed=11), **_extra_cols(6, seed=12)}
    labels = ["unused_label"]
    jb = JaxParser(jf, labels=labels).parse_to_batch(cols)
    pb = DataParser(pf, labels=labels).parse_to_batch(cols)
    return jcfg, pcfg, jf, pf, jb, pb


def _eq(got, ref):
    if ref is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_parser_matches_jax(parsed):
    _, _, _, _, jb, pb = parsed
    for attr in ("sparse_features", "sequence_sparse_features"):
        j, p = getattr(jb, attr), getattr(pb, attr)
        assert sorted(j) == sorted(p)
        for name in j:
            _eq(p[name].values, j[name].values)
            _eq(p[name].lengths, j[name].lengths)
            _eq(p[name].weights, j[name].weights)
    assert sorted(pb.sequence_dense_features) == sorted(
        jb.sequence_dense_features)
    for name, f in jb.sequence_dense_features.items():
        _eq(pb.sequence_dense_features[name].values, f.values)
        _eq(pb.sequence_dense_features[name].lengths, f.lengths)
    assert sorted(pb.dense_features) == sorted(jb.dense_features)
    for name, f in jb.dense_features.items():
        _eq(pb.dense_features[name].values, f.values)
    _eq(pb.labels["unused_label"], jb.labels["unused_label"])
    # the extra features exercise jagged pooled ids and multi-value steps
    assert not pb.sparse_features["tags"].is_fixed
    assert pb.sequence_sparse_features["seq_tags"].values.dim() == 3


def test_embedding_group_matches_jax(parsed):
    import jax

    jcfg, pcfg, jf, pf, jb, pb = parsed
    jg = JaxGroup(jf, list(jcfg.model_config.feature_groups))
    tables = jg.init_tables(jax.random.key(0))
    jparams = jg.init(jax.random.key(1))
    ref, _ = jg.forward(tables, jb, jparams, JM.Context())
    pg = EmbeddingGroup(pf, list(pcfg.model_config.feature_groups),
                        torch.Generator())
    pg.load_state_dict({
        f"tables.{name}": torch.from_numpy(
            np.array(jg.engine.extract_table(tables, name), np.float32))
        for name in pg.tables
    })
    with torch.no_grad():
        got = pg(pb, torch.float32)
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    assert pg.seq_group_dims() == jg.seq_group_dims()
    assert pg.group_dims("deep") == jg.group_dims("deep")

"""The port's dynamicemb tools (tools/dynamicemb) against the JAX
package's, on the CPU, over one small ZCH config and one file of
pretrained vectors:

- ``create_zch_init_ckpt``: the same ids inserted, the same ZCH mapping
  (keys, counts, last access) exactly, and each resident id's row its
  pretrained vector, in the same slot as the JAX checkpoint's;
- ``convert_zch_ckpt`` to a smaller ZCH table: the same kept and dropped
  counts, the same mapping, the same rows (hottest first);
- ``convert_zch_ckpt`` to a static table (``key % rows``): the same
  rows as the JAX conversion; ``--dump_dir``: the same (id, embedding,
  score) parquet."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torcheasyrec_tpu.tools.dynamicemb import convert_zch_ckpt as jconv
from torcheasyrec_tpu.tools.dynamicemb import create_zch_init_ckpt as jinit
from torcheasyrec_tpu_torch.tools.dynamicemb import convert_zch_ckpt as pconv
from torcheasyrec_tpu_torch.tools.dynamicemb import (
    create_zch_init_ckpt as pinit,
)
from torcheasyrec_tpu_torch.utils import checkpoint_util

CFG = """
train_input_path: "{tmp}/train.parquet"
eval_input_path: "{tmp}/train.parquet"
model_dir: "{tmp}/model"
train_config {{
    sparse_optimizer {{ adagrad_optimizer {{ lr: 0.1 }}
                        constant_learning_rate {{}} }}
    dense_optimizer {{ adam_optimizer {{ lr: 0.01 }}
                       constant_learning_rate {{}} }}
    num_epochs: 1
}}
data_config {{
    batch_size: 64
    dataset_type: ParquetDataset
    fg_mode: FG_NONE
    label_fields: "label"
}}
feature_configs {{
    id_feature {{ feature_name: "raw_id" embedding_dim: 8 {id_table} }}
}}
model_config {{
    feature_groups {{ group_name: "deep" feature_names: "raw_id"
                      group_type: DEEP }}
    deepfm {{ deep {{ hidden_units: [16] }} }}
    losses {{ binary_cross_entropy {{}} }}
    metrics {{ auc {{}} }}
}}
"""
T = "raw_id_emb"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tools"))
    rng = np.random.default_rng(3)
    # 90 ids into 64 slots: the later ids evict earlier ones
    ids = rng.choice(2 ** 30, size=90, replace=False).astype(np.int64)
    vecs = rng.normal(size=(90, 8)).astype(np.float32)
    pq.write_table(pa.table({"raw_id": pa.array(ids[:16]),
                             "label": pa.array(np.zeros(16, np.float32))}),
                   os.path.join(tmp, "train.parquet"))
    vec_path = os.path.join(tmp, "vectors.parquet")
    pq.write_table(pa.table({
        "id": pa.array(ids),
        "embedding": pa.array(vecs.tolist(), pa.list_(pa.float32()))}),
        vec_path)

    def cfg(name, id_table):
        p = os.path.join(tmp, name)
        with open(p, "w") as f:
            f.write(CFG.format(tmp=tmp, id_table=id_table))
        return p

    old = cfg("zch.config", "zch { zch_size: 64 lfu {} }")
    jdir, pdir = os.path.join(tmp, "jax_init"), os.path.join(tmp, "port_init")
    jn = jinit.create_init_ckpt(old, {T: vec_path}, jdir)
    pn = pinit.create_init_ckpt(old, {T: vec_path}, pdir, device="cpu")
    return {"tmp": tmp, "cfg": cfg, "old": old, "jdir": jdir,
            "pckpt": checkpoint_util.latest_checkpoint(pdir),
            "inserted": (jn, pn)}


def _jax_raw(ckpt_dir):
    return jconv._load_raw_ckpt(ckpt_dir)


def _assert_same(raw, ckpt_path):
    """The same ZCH mapping, and each occupied slot's row the same (the
    empty ones keep each package's own init)."""
    sd = torch.load(ckpt_path, weights_only=True)["model"]
    occ = np.asarray(raw["zch"][T]["keys"]) >= 0
    np.testing.assert_array_equal(
        sd[f"embedding_group.tables.{T}"].numpy()[occ],
        np.asarray(raw["canonical_tables"][T]["weight"])[occ])
    for k, v in raw["zch"][T].items():
        np.testing.assert_array_equal(
            sd[f"embedding_group.zch.{T}.{k}"].numpy(), np.asarray(v),
            err_msg=k)


def test_create_zch_init_ckpt_matches_jax(env):
    jn, pn = env["inserted"]
    assert jn == pn and 50 <= pn[T] <= 64
    _assert_same(_jax_raw(env["jdir"]), env["pckpt"])
    with pytest.raises(ValueError, match="not a ZCH table"):
        pinit.create_init_ckpt(env["old"], {"nope": "x"},
                               os.path.join(env["tmp"], "bad"),
                               device="cpu")


def test_convert_to_a_smaller_zch_table_matches_jax(env):
    new = env["cfg"]("small.config", "zch { zch_size: 32 lfu {} }")
    jsave = os.path.join(env["tmp"], "jax_small")
    psave = os.path.join(env["tmp"], "port_small")
    jrep = jconv.convert_zch_ckpt(env["old"], env["jdir"], new, jsave)
    prep = pconv.convert_zch_ckpt(env["old"], env["pckpt"], new, psave,
                                  device="cpu")
    assert prep == jrep and 0 < prep[T]["kept"] <= 32
    _assert_same(_jax_raw(jsave), checkpoint_util.latest_checkpoint(psave))


def test_convert_to_static_and_dump_match_jax(env):
    new = env["cfg"]("static.config", "num_buckets: 48")
    jsave = os.path.join(env["tmp"], "jax_static")
    psave = os.path.join(env["tmp"], "port_static")
    jdump, pdump = (os.path.join(env["tmp"], d) for d in ("jd", "pd"))
    jrep = jconv.convert_zch_ckpt(env["old"], env["jdir"], new, jsave,
                                  dump_dir=jdump)
    prep = pconv.convert_zch_ckpt(env["old"], env["pckpt"], new, psave,
                                  dump_dir=pdump, device="cpu")
    assert prep == jrep
    # the rows the keys took (the others keep each package's own init)
    keys = _jax_raw(env["jdir"])["zch"][T]["keys"]
    rows = np.unique(np.asarray(keys)[np.asarray(keys) >= 0] % 48)
    sd = torch.load(checkpoint_util.latest_checkpoint(psave),
                    weights_only=True)["model"]
    np.testing.assert_array_equal(
        sd[f"embedding_group.tables.{T}"].numpy()[rows],
        np.asarray(_jax_raw(jsave)["canonical_tables"][T]["weight"])[rows])
    a, b = (pq.read_table(os.path.join(d, f"{T}.parquet"))
            for d in (pdump, jdump))
    assert a.equals(b)

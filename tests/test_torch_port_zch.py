"""The port's ZCH remap (parallel/zch.py) and its wiring, on the CPU,
against the JAX package:

- ``lookup_insert``'s slots, state and spill records after a sequence of
  batches (padding, duplicates, train and eval steps), exactly, under
  lfu, lru and distance_lfu, with interval gating, frequency admission
  and a ``threshold_filtering_func``; new ids racing for one slot;
- features sharing an ``embedding_name`` share one mapping;
- ids of 2^31 and more wrap at the parse's int32 cast, as in the JAX
  package (ROADMAP §3, known behaviours);
- ZCH on a host-offloaded table raises, and so does a host-offloaded
  table beside ZCH over two ranks;
- ``evaluate`` and ``predict_checkpoint`` of a DeepFM with ZCH (three
  policies), dynamicemb (frequency admission) and a host-offloaded
  table, from a JAX checkpoint (the JAX init, its ZCH mappings advanced
  over the train rows) carried across by utils/convert.py, beside the
  JAX package's: the AUC and loss within rtol 1e-4 / atol 1e-5 and
  the predictions within rtol 1e-5 / atol 1e-6 (the DeepFM parity
  tolerances). The training loop's parity is in
  test_torch_port_zch_spill.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import (
    deepfm_cols,
    deepfm_table_names,
    jax_model_and_state,
    zch_deepfm_config_text,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.parallel import zch as jzch
from torcheasyrec_tpu.utils import checkpoint_util as jax_ckpt
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.parallel import zch as pzch
from torcheasyrec_tpu_torch.utils.convert import from_jax_state

EVAL_TOL = dict(rtol=1e-4, atol=1e-5)

_VARIANTS = {
    "plain": {},
    "interval": {"eviction_interval": 3},
    "admission": {"admit_threshold": 2, "counter_size": 256},
    "filter": {"filter_fn": "lambda counts: counts >= 2"},
}


def _run_both(jcfg, steps, seed, n=96, vocab=150, eval_every=4):
    """Feed the same batches to both packages; assert slots, state and
    spill records equal after every one."""
    pcfg = pzch.ZchConfig(**jcfg.__dict__)
    cs = jcfg.counter_size if jcfg.admit_threshold > 0 else 0
    jst, pst = jzch.init_state(jcfg.size, cs), pzch.init_state(jcfg.size, cs)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        ids = rng.integers(-1, vocab, size=n)
        ids[:6] = ids[6]  # a duplicated id
        training = step % eval_every != eval_every - 1
        a, jst, jsp = jzch.lookup_insert(
            jst, jcfg, jnp.asarray(ids, jnp.int32), jnp.int32(step),
            training, collect_spill=True)
        b, pst, psp = pzch.lookup_insert(pst, pcfg, torch.from_numpy(ids),
                                         step, training, collect_spill=True)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"slots step {step}")
        assert set(pst) == set(jst)
        for k in jst:
            np.testing.assert_array_equal(pst[k].numpy(), np.asarray(jst[k]),
                                          err_msg=f"{k} step {step}")
        for k in jsp:
            np.testing.assert_array_equal(psp[k].numpy(), np.asarray(jsp[k]),
                                          err_msg=f"spill {k} step {step}")
    return pst


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("policy", ["lfu", "lru", "distance_lfu"])
def test_lookup_insert_matches_jax(policy, variant):
    cfg = jzch.ZchConfig(
        size=64, policy=policy,
        decay_exponent=1.0 if policy == "lfu" else 0.7,
        **_VARIANTS[variant])
    st = _run_both(cfg, steps=12, seed=hash((policy, variant)) % 1000)
    assert int((st["keys"] >= 0).sum()) > 32  # the table filled up


@pytest.mark.parametrize("size", [1, 4])
def test_new_ids_racing_for_one_slot_match_jax(size):
    """Distinct new ids whose probes all collide: the largest flat
    position wins the slot, its count is the number of writers."""
    cfg = jzch.ZchConfig(size=size, policy="lfu")
    st = _run_both(cfg, steps=6, seed=size, n=12, vocab=40, eval_every=3)
    assert int((st["keys"] >= 0).sum()) == size


def _group(feature_texts, group_names):
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    feats = create_features([text_format.Parse(t, feature_pb2.FeatureConfig())
                             for t in feature_texts])
    names = "".join(f'feature_names: "{n}" ' for n in group_names)
    mc = text_format.Parse(
        f'feature_groups {{ group_name: "g" {names} group_type: DEEP }}',
        model_pb2.ModelConfig())
    return feats, list(mc.feature_groups)


def test_shared_embedding_one_mapping():
    from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup

    feats, groups = _group([
        "id_feature { feature_name: 'item' embedding_dim: 8 "
        "embedding_name: 'item_emb' zch { zch_size: 64 lfu {} } }",
        "id_feature { feature_name: 'click_item' embedding_dim: 8 "
        "embedding_name: 'item_emb' zch { zch_size: 64 lfu {} } }",
    ], ["item", "click_item"])
    eg = EmbeddingGroup(feats, groups, torch.Generator())
    assert set(eg.zch_states()) == {"item_emb"}
    batch = Batch(sparse_features={
        "item": SparseField(torch.tensor([[42], [7]], dtype=torch.int32)),
        "click_item": SparseField(torch.tensor([[42], [99]],
                                               dtype=torch.int32)),
    })
    new, _ = eg.remap_zch(batch, 1, True)
    s_item = new.sparse_features["item"].values
    s_click = new.sparse_features["click_item"].values
    assert s_item[0, 0] == s_click[0, 0] and s_item[1, 0] != s_click[1, 0]
    assert int((eg.zch_states()["item_emb"]["keys"] >= 0).sum()) == 3


def test_ids_past_int32_wrap_as_in_jax():
    """Both parsers cast ids to int32: 2^31 + 5 wraps negative (padding:
    slot -1, never inserted) and 2^32 + 7 aliases 7."""
    from torcheasyrec_tpu.datasets.data_parser import DataParser as JParser
    from torcheasyrec_tpu.features import create_features as jcreate
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.features import create_features
    from google.protobuf import text_format
    from torcheasyrec_tpu.protos import feature_pb2 as jfpb
    from torcheasyrec_tpu_torch.protos import feature_pb2

    text = ("id_feature { feature_name: 'raw' embedding_dim: 4 "
            "zch { zch_size: 64 lfu {} } }")
    ids = np.asarray([7, 2 ** 31 + 5, 2 ** 32 + 7, 12, 2 ** 31 - 1], np.int64)
    cols = {"raw": pa.array(ids)}
    jb = JParser(jcreate([text_format.Parse(text, jfpb.FeatureConfig())]),
                 labels=[]).parse_to_batch(cols)
    pb = DataParser(create_features([text_format.Parse(
        text, feature_pb2.FeatureConfig())]), labels=[]).parse_to_batch(cols)
    jv = np.asarray(jb.sparse_features["raw"].values)
    pv = pb.sparse_features["raw"].values
    np.testing.assert_array_equal(pv.numpy(), jv)
    cfg = jzch.ZchConfig(size=64)
    a, _ = jzch.lookup_insert(jzch.init_state(64), cfg, jnp.asarray(jv),
                              jnp.int32(1), True)
    b, _ = pzch.lookup_insert(pzch.init_state(64), pzch.ZchConfig(size=64),
                              pv, 1, True)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    s = b.reshape(-1).numpy()
    assert s[1] == -1 and s[2] == s[0] and s[4] >= 0


def test_zch_over_two_ranks_raises():
    """A ZCH table builds over two ranks (one mapping over the global
    batch: tests/test_torch_port_zch_ranks.py); beside a host-offloaded
    table, which runs on one rank only, the build still raises."""
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.parallel.mesh import ShardContext

    zch = ("id_feature { feature_name: 'a' embedding_dim: 8 "
           "dynamicemb { max_capacity: 64 } }")
    shard = ShardContext(0, 2, torch.device("cpu"))
    feats, groups = _group([zch], ["a"])
    eg = EmbeddingGroup(feats, groups, torch.Generator(), shard=shard,
                        build_tables=False)
    assert eg.has_zch and eg.has_host_spill
    feats, groups = _group([zch, (
        "id_feature { feature_name: 'h' embedding_dim: 8 num_buckets: 50 "
        "embedding_constraints { sharding_types: 'host_offload' } }")],
        ["a", "h"])
    with pytest.raises(NotImplementedError, match="one rank"):
        EmbeddingGroup(feats, groups, torch.Generator(), shard=shard,
                       build_tables=False)


def test_zch_on_a_host_offloaded_table_raises():
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup

    feats, groups = _group([
        "id_feature { feature_name: 'a' embedding_dim: 8 "
        "zch { zch_size: 64 } embedding_constraints { "
        "sharding_types: 'host_offload' } }"], ["a"])
    with pytest.raises(ValueError, match="cannot be host_offload"):
        EmbeddingGroup(feats, groups, torch.Generator())


def test_filter_fn_with_a_function_torch_lacks_raises():
    cfg = pzch.ZchConfig(size=8, filter_fn="lambda c: jnp.not_in_torch(c)")
    with pytest.raises(NotImplementedError, match="not_in_torch"):
        pzch.lookup_insert(pzch.init_state(8), cfg,
                           torch.tensor([1, 2, 2]), 1, True)


# --- eval and predict from a JAX checkpoint ---------------------------------


def test_evaluate_and_predict_match_jax(tmp_path, monkeypatch):
    from torcheasyrec_tpu.datasets.data_parser import DataParser as JParser

    root = str(tmp_path)
    tbl = pa.table(deepfm_cols(512 + 256, 7))
    train, evalp = (os.path.join(root, f) for f in ("train.parquet",
                                                     "eval.parquet"))
    pq.write_table(tbl.slice(0, 512), train)
    pq.write_table(tbl.slice(512), evalp)
    model_dir = os.path.join(root, "model")
    text = zch_deepfm_config_text(train, evalp, batch_size=64,
                                  model_dir=model_dir)
    cfg = os.path.join(root, "pipeline.config")
    with open(cfg, "w") as f:
        f.write(text)
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(text)
    _, _, sparse_opt = jax_main._init_state(jmodel, None)
    eg = jmodel.embedding_group
    zst = eg.init_zch_states()
    parser = JParser(jfeatures, labels=["label"])
    for step in range(8):
        cols = {k: tbl.column(k).slice(64 * step, 64)
                for k in tbl.column_names}
        _, zst = eg.remap_zch(parser.parse_to_batch(cols), zst,
                              jnp.int32(step), True)
    jax_ckpt.save_train_state(
        os.path.join(model_dir, "model.ckpt-8"), jmodel,
        {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
         "zch": zst, "step": jnp.int32(8)})
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jres = jax_main.evaluate(cfg)
    jax_main.predict_checkpoint(cfg, evalp, os.path.join(root, "jax.parquet"))

    engine = eg.engine
    ckpt = os.path.join(root, "carried.pt")
    torch.save(from_jax_state(
        jax.device_get(dense),
        {n: np.asarray(engine.extract_table(tables, n))
         for n in deepfm_table_names()},
        zch=jax.device_get(zst)), ckpt)
    pres = port_main.evaluate(cfg, checkpoint_path=ckpt, device="cpu")
    for k in ("auc", "loss_binary_cross_entropy"):
        np.testing.assert_allclose(pres[k], jres[k], err_msg=k, **EVAL_TOL)
    port_main.predict_checkpoint(cfg, evalp, os.path.join(root, "port.parquet"),
                                 checkpoint_path=ckpt, device="cpu")
    jp = pq.read_table(os.path.join(root, "jax.parquet"))
    pp = pq.read_table(os.path.join(root, "port.parquet"))
    assert pp.num_rows == jp.num_rows == 256
    for col in ("probs", "logits"):
        np.testing.assert_allclose(pp[col].to_numpy(), jp[col].to_numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=col)

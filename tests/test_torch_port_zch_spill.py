"""The port's host spill tier behind the ZCH / dynamicemb tables
(parallel/host_spill.py, EmbeddingGroup's spill methods,
EmbeddingEngine.write_logical_rows) and the ZCH training loop, on the
CPU, against the JAX package:

- ``HostSpillStore`` against the JAX store over one random sequence of
  stores and takes (duplicates: last write wins on store, first position
  on take; the LRU bound; tombstones): the same hits, rows and counters,
  exactly; its ``state_dict`` round trip continues alike;
- ``write_logical_rows`` on packed and unpacked groups: the same tables
  as the JAX engine's, and the in-row optimizer state untouched;
- an evicted key's trained row comes back on readmission;
- a DeepFM with ZCH (three policies), dynamicemb (the spill tier,
  frequency admission) and a host-offloaded table through
  ``train_and_evaluate`` beside the JAX package's from the same weights:
  ZCH mappings exactly equal, tables and row state within 1e-5 and dense
  parameters within 1e-4 of each tensor's max, evals within rtol 1e-4 /
  atol 1e-5 (the DeepFM parity tolerances) at the end, keys spilled and
  restored;
- ``continue_train`` from step 6 bit-equal to 12 steps straight (the
  spill stores travel in the checkpoint). The export of this model is
  held in test_torch_port_host_offload.py, the spill tier turned off in
  test_torch_port_zch_spill_off.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import (
    assert_close_to_max,
    converted_state,
    deepfm_cols,
    deepfm_table_names,
    jax_model_and_state,
    zch_deepfm_config_text,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.parallel import host_spill as jspill
from torcheasyrec_tpu.utils import checkpoint_util as jax_ckpt
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.parallel import host_spill as pspill
from torcheasyrec_tpu_torch.utils import checkpoint_util
from torcheasyrec_tpu_torch.utils.convert import from_jax_state

TABLE_TOL = 1e-5
DENSE_TOL = 1e-4
EVAL_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_items", [0, 40])
def test_spill_store_matches_jax(max_items):
    rng = np.random.default_rng(max_items)
    a, b = pspill.HostSpillStore(3, max_items), jspill.HostSpillStore(
        3, max_items)

    def check():
        assert (len(a), a.stored, a.restored, a.dropped) == (
            len(b), b.stored, b.restored, b.dropped)

    for i in range(30):
        keys = rng.integers(-1, 120, size=rng.integers(1, 24))
        if i % 3 != 2:
            rows = rng.normal(size=(keys.size, 3)).astype(np.float32)
            assert a.store(keys, rows) == b.store(keys, rows)
        else:
            ia, ra = a.take(keys)
            ib, rb = b.take(keys)
            assert ia == ib
            np.testing.assert_array_equal(ra, rb)
        check()
        if i == 15:
            # a checkpoint round trip in the middle of the sequence
            c = pspill.HostSpillStore(3, max_items)
            c.load_state_dict(a.state_dict())
            a = c
            check()
    probe = np.arange(-1, 120)
    ia, ra = a.take(probe)
    ib, rb = b.take(probe)
    assert ia == ib and len(ia) > 0
    np.testing.assert_array_equal(ra, rb)


def _engines(sparse_opt, packed):
    """A JAX engine and the port's over the same tables (three dim-8
    tables, one of them below the dense lane), the port's holding the
    JAX engine's initial tables and row state (a write that reached the
    row state would replace its fill value with a row's)."""
    from torcheasyrec_tpu.parallel import emb_engine as je
    from torcheasyrec_tpu.parallel.sparse_optim import (
        SparseOptimizer as JOpt,
    )
    from torcheasyrec_tpu_torch.parallel import emb_engine as pe
    from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer

    names = {"a": 300, "b": 40, "c": 123}
    jeng = je.EmbeddingEngine(
        [je.TableSpec(n, r, 8) for n, r in names.items()],
        [je.LookupSpec(n, f"f_{n}", n) for n in names],
        optimizer=JOpt(sparse_opt, {"lr": 0.1}))
    jt, js = jeng.init(jax.random.key(3)), jeng.init_opt_state()
    peng = pe.EmbeddingEngine(
        [pe.TableSpec(n, r, 8) for n, r in names.items()],
        [pe.LookupSpec(n, f"f_{n}", n) for n in names],
        optimizer=SparseOptimizer(sparse_opt, {"lr": 0.1}), packed=packed,
        dense_lane_rows=64)
    pt = peng.init_tables(torch.Generator())
    ps = peng.init_opt_state()
    for n in names:
        peng.write_table(pt, n, torch.from_numpy(np.asarray(
            jeng.extract_table(jt, n))))
        peng.write_table_state(pt, ps, n, {
            k: np.asarray(v) for k, v in jeng.extract_table_state(
                jt, js, n).items()})
    return names, jeng, jt, js, peng, pt, ps


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_write_logical_rows_matches_jax(packed):
    names, jeng, jt, js, peng, pt, ps = _engines("rowwise_adagrad", packed)
    assert any(g.packed for g in peng.groups.values()) == packed
    rng = np.random.default_rng(1)
    for n, rows in names.items():
        ids = rng.integers(-1, rows, size=20)
        ids[3] = ids[9]  # a duplicate: the last write wins
        vals = rng.normal(size=(20, 8)).astype(np.float32)
        jgk, joff, _, coff, _ = jeng._table_slice(n)
        jt = dict(jt)
        jt[jgk] = jeng.write_logical_rows(
            jt[jgk], jeng.groups[jgk],
            jnp.asarray(np.where(ids >= 0, ids + joff, -1), jnp.int32),
            jnp.asarray(vals), coff)
        pgk, poff, _ = peng.table_rows(n)
        peng.write_logical_rows(
            pt[pgk], peng.groups[pgk],
            torch.from_numpy(np.where(ids >= 0, ids + poff, -1)),
            torch.from_numpy(vals))
    for n in names:
        np.testing.assert_array_equal(
            peng.extract_table(pt, n).numpy(),
            np.asarray(jeng.extract_table(jt, n)), err_msg=n)
        jst = jeng.extract_table_state(jt, js, n)
        pst = peng.extract_table_state(pt, ps, n)
        np.testing.assert_array_equal(pst["acc"].numpy(),
                                      np.asarray(jst["acc"]), err_msg=n)


def test_evict_readmit_recovers_trained_vector():
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField
    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    dim = 8
    feats = create_features([text_format.Parse(
        f"id_feature {{ feature_name: 'dyn' embedding_dim: {dim} "
        "dynamicemb { max_capacity: 8 score_strategy: 'LFU' } }",
        feature_pb2.FeatureConfig())])
    mc = text_format.Parse('feature_groups { group_name: "deep" '
                           'feature_names: "dyn" group_type: DEEP }',
                           model_pb2.ModelConfig())
    eg = EmbeddingGroup(feats, list(mc.feature_groups), torch.Generator())
    assert eg.has_host_spill
    gk, off, _ = eg.engine.table_rows("dyn_emb")
    g = eg.engine.groups[gk]

    def step(ids, i):
        batch = Batch(sparse_features={"dyn": SparseField(
            torch.tensor(ids, dtype=torch.int32)[:, None])})
        nb, spills = eg.remap_zch(batch, i, True, collect_spill=True)
        eg.spill_step(eg.gather_spill_rows(spills))
        return nb.sparse_features["dyn"].values.reshape(-1)

    key = 777_001
    v = torch.linspace(3.0, 4.0, dim)
    slot = int(step([key] * 8, 1)[0])
    eg.engine.write_logical_rows(eg.engine_tables()[gk], g,
                                 torch.tensor([off + slot]), v[None])
    store = eg.spill.stores["dyn_emb"]
    i = 2
    for wave in range(40):
        for _ in range(3):
            step([5000 + 16 * wave + j for j in range(16)], i)
            i += 1
        if key in store:
            break
    np.testing.assert_array_equal(store.get(key), v.numpy())
    for _ in range(30):
        s = int(step([key] * 8, i)[0])
        i += 1
        if key not in store and s >= 0:
            break
    else:
        raise AssertionError("the key was never readmitted")
    got = eg.engine.read_rows(eg.engine_tables(), "dyn_emb",
                              torch.tensor([s]))[0]
    np.testing.assert_array_equal(got.numpy(), v.numpy())


# --- the DeepFM through the entry points -----------------------------------

STEPS, SAVE_EVERY, BATCH = 12, 6, 64


def _train_both(root, steps, resume=False):
    """The JAX package's and the port's ``train_and_evaluate`` of the ZCH
    DeepFM from the same weights; with ``resume`` the port's also stopped
    at step ``SAVE_EVERY`` and continued."""
    tbl = pa.table(deepfm_cols(1024 + 256, 5))
    train, evalp = (os.path.join(root, f) for f in ("train.parquet",
                                                     "eval.parquet"))
    pq.write_table(tbl.slice(0, 1024), train)
    pq.write_table(tbl.slice(1024), evalp)

    def cfg(name, save_every=SAVE_EVERY):
        text = zch_deepfm_config_text(
            train, evalp, batch_size=BATCH, num_steps=steps,
            model_dir=os.path.join(root, name),
            train_extra=f"  save_checkpoints_steps: {save_every}")
        path = os.path.join(root, f"{name}.config")
        with open(path, "w") as f:
            f.write(text)
        return path, text

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_main, "maybe_mesh", lambda: None)
    try:
        # the JAX run saves and evaluates at the end only
        jcfg, text = cfg("jax", save_every=10 * steps)
        jax_main.train_and_evaluate(jcfg)
    finally:
        mp.undo()
    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = os.path.join(root, "init.pt")
    torch.save(converted_state(jmodel, dense, tables, deepfm_table_names()),
               init)
    pcfg, _ = cfg("port")
    port_main.train_and_evaluate(pcfg, fine_tune_checkpoint=init,
                                 device="cpu")
    if resume:
        rcfg, _ = cfg("resumed")
        port_main.train_and_evaluate(
            rcfg, fine_tune_checkpoint=init, device="cpu",
            edit_config_json=json.dumps(
                {"train_config.num_steps": SAVE_EVERY}))
        port_main.train_and_evaluate(rcfg, continue_train=True,
                                     device="cpu")
    return {"root": root, "jmodel": jmodel, "dense": dense,
            "tables": tables}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return _train_both(str(tmp_path_factory.mktemp("zch")), STEPS,
                       resume=True)


def _eval_lines(model_dir):
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        return [json.loads(line) for line in f]


def _assert_port_matches_jax(trained, steps):
    """The port's last checkpoint against the JAX run's: ZCH mappings
    exactly, tables and row state within ``TABLE_TOL``, dense parameters
    within ``DENSE_TOL`` of each tensor's max; the port's checkpoint."""
    root, jmodel = trained["root"], trained["jmodel"]
    _, _, so = jax_main._init_state(jmodel, None)
    js = jax_ckpt.restore_train_state(
        jax_ckpt.latest_checkpoint(os.path.join(root, "jax")), jmodel,
        {"dense": trained["dense"], "tables": trained["tables"],
         "sparse_opt": so, "step": jnp.zeros((), jnp.int32),
         "zch": jmodel.embedding_group.init_zch_states()})
    ck = torch.load(checkpoint_util.latest_checkpoint(
        os.path.join(root, "port")), weights_only=True)
    assert ck["step"] == steps
    sd = ck["model"]
    for t, st in js["zch"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(
                sd[f"embedding_group.zch.{t}.{k}"].numpy(), np.asarray(v),
                err_msg=f"{t}.{k}")
    eng = jmodel.embedding_group.engine
    ref = from_jax_state(jax.device_get(js["dense"]), {
        n: np.asarray(eng.extract_table(js["tables"], n))
        for n in deepfm_table_names()})
    for name, r in ref.items():
        assert_close_to_max(sd[name].numpy(), r.numpy(), name,
                            TABLE_TOL if "tables." in name else DENSE_TOL)
    for n in deepfm_table_names():
        for k, v in eng.extract_table_state(js["tables"], js["sparse_opt"],
                                            n).items():
            v = np.asarray(v)
            assert_close_to_max(ck["sparse_opt"][n][k].numpy().reshape(
                v.shape), v, f"{n}.{k}", TABLE_TOL)
    return ck


def test_train_and_evaluate_matches_jax(trained):
    root = trained["root"]
    ck = _assert_port_matches_jax(trained, STEPS)
    ours, theirs = (_eval_lines(os.path.join(root, d))
                    for d in ("port", "jax"))
    assert [r["global_step"] for r in ours] == [6, 12, 12]
    assert theirs[-1]["global_step"] == 12
    for k in ("auc", "loss_binary_cross_entropy"):
        np.testing.assert_allclose(ours[-1][k], theirs[-1][k], err_msg=k,
                                   **EVAL_TOL)
    # the spill tier ran: keys stored on eviction and restored
    _, stored, restored, _ = ck["zch_spill"]["cat_4_emb"]["meta"].tolist()
    assert stored > 0 and restored > 0, (stored, restored)


def test_continue_train_is_bit_equal_to_a_straight_run(trained):
    root = trained["root"]
    a, b = (torch.load(checkpoint_util.latest_checkpoint(
        os.path.join(root, d)), weights_only=True)
        for d in ("port", "resumed"))
    assert a["step"] == b["step"] == STEPS
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for t in a["sparse_opt"]:
        for k in a["sparse_opt"][t]:
            assert torch.equal(a["sparse_opt"][t][k], b["sparse_opt"][t][k])
    assert a["zch_spill"].keys() == b["zch_spill"].keys() == {
        "cat_4_emb", "cat_5_emb"}
    for t in a["zch_spill"]:
        for k in a["zch_spill"][t]:
            assert torch.equal(a["zch_spill"][t][k], b["zch_spill"][t][k])


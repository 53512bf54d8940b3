"""ZCH and dynamic embeddings over two ranks of the port, on the CPU
(gloo, one spawn of two ranks for the whole file, ``FileStore`` under
``tmp_path``; the ranks run ``tests/torch_port_dist_ranks.py``, the JAX
references run in the parent meanwhile). Rank 0 takes 5/8 of every
global batch and rank 1 the rest, so the ranks' id counts differ.

- The global-batch remap: two features sharing one table (two ids a
  row, a jagged list), eight steps of which two are eval steps, under
  lfu, lru, distance_lfu, interval eviction and frequency admission.
  Each rank's slots are its slice of the JAX ``lookup_insert``'s on the
  concatenated batch, exactly; the mapping, its scores and the admission
  counters equal the JAX state on both ranks; the spill records are the
  global batch's. The eval steps remap each rank's ids alone (no
  gather) and still give the slice of the JAX read-only remap.
- A narrow ZCH DeepFM (three ZCH policies and two dynamicemb tables
  with the spill tier, in the row_wise, column_wise, table_wise and
  data_parallel layouts) trained 3 steps at world size 2 against a
  one-rank run of the port over the global batches: mappings bit-equal,
  tables and dense parameters within 1e-6 of each tensor's max (compared
  as tests/test_torch_port_dist_train.py compares its layouts), the
  merged spill stores equal to the one-rank stores. Its checkpoint goes
  from world size 2 to 1 and back to 2 with predictions bit-equal.
- The mirror of the JAX package's ``test_spill_restore_row_wise_mesh``:
  a key's written row is stored on eviction by the rank holding its slot
  and comes back on readmission; restores that each rank takes from its
  store travel to the rank holding their new slot.
- ``write_logical_rows`` under row_wise, column_wise, table_wise and
  data_parallel: every rank given the same rows writes those it holds,
  packed blocks through the row write; the gathered tables equal a
  one-rank engine's.
- ``train_and_evaluate``, ``continue_train`` and ``evaluate`` of the ZCH
  DeepFM at world size 2 (the mappings checked equal on the ranks at
  every save), its AUC equal to a one-rank ``evaluate`` of the same
  checkpoint.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torcheasyrec_tpu.parallel import zch as jzch
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.utils import checkpoint_util, dist_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_dist_ranks as R  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    DEEPFM_BUCKETS,
    ZCH_FEATURES,
    assert_close_to_max,
    deepfm_cols,
    deepfm_config_text,
)

TOL = 1e-6
SIZE = 48
# name -> (the feature's ZCH block, the JAX ZchConfig's fields)
REMAP_CASES = {
    "lfu": ("zch { zch_size: 48 lfu {} eviction_interval: 1 }",
            {"policy": "lfu"}),
    "lru": ("zch { zch_size: 48 lru { decay_exponent: 0.7 } "
            "eviction_interval: 1 }",
            {"policy": "lru", "decay_exponent": 0.7}),
    "distance_lfu": (
        "zch { zch_size: 48 distance_lfu { decay_exponent: 0.7 } "
        "eviction_interval: 1 }",
        {"policy": "distance_lfu", "decay_exponent": 0.7}),
    "interval": ("zch { zch_size: 48 lfu {} eviction_interval: 3 }",
                 {"policy": "lfu", "eviction_interval": 3}),
    "admission": ('dynamicemb { max_capacity: 48 score_strategy: "LFU" '
                  "frequency_admission_strategy { threshold: 2 } }",
                  {"policy": "lfu", "admit_threshold": 2,
                   "counter_size": 4 * 48}),
}
REMAP_STEPS, REMAP_B, REMAP_N = 8, 16, 24
TRAIN_FLAGS = [i % 4 != 3 for i in range(REMAP_STEPS)]


def _remap_batches(seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(REMAP_STEPS):
        a = r.integers(-1, 90, (REMAP_B, 2))
        a[REMAP_B - 1] = a[0]  # the same ids on both ranks
        # a jagged list of REMAP_N ids over the rows (one shape a step
        # for the jitted JAX reference)
        lengths = r.multinomial(REMAP_N, np.full(REMAP_B, 1.0 / REMAP_B))
        out.append({"a": a, "b": (r.integers(0, 90, REMAP_N), lengths)})
    return out


def _jax_remap(fields, batches):
    """Per step: the JAX ``lookup_insert``'s slots of ``a`` and ``b``
    over the global batch, state threaded a then b, and the spill
    records of both concatenated; then the final state."""
    cfg = jzch.ZchConfig(size=SIZE, **fields)
    st = jzch.init_state(SIZE, cfg.counter_size if cfg.admit_threshold
                         else 0)
    fns = {t: jax.jit(lambda s, ids, step, t=t: jzch.lookup_insert(
        s, cfg, ids, step, t, collect_spill=True)) for t in (True, False)}
    out = []
    for i, (b, training) in enumerate(zip(batches, TRAIN_FLAGS)):
        res = []
        for ids in (b["a"], b["b"][0]):
            slots, st, rec = fns[training](
                st, jnp.asarray(ids, jnp.int32), jnp.int32(i))
            res.append((np.asarray(slots), {k: np.asarray(v)
                                            for k, v in rec.items()}))
        out.append((res[0][0], res[1][0], {
            k: np.concatenate([res[0][1][k], res[1][1][k]])
            for k in res[0][1]}))
    return out, {k: np.asarray(v) for k, v in st.items()}


# --- the ZCH DeepFM ------------------------------------------------------------

DEEPFM_B = 32
# dynamicemb cat_4 at 16 slots: evictions and readmissions in 3 steps
DEEPFM_ZCH = {**ZCH_FEATURES,
              4: 'dynamicemb { max_capacity: 16 score_strategy: "STEP" }'}
PLAN = {"cat_0_emb": "row_wise", "cat_1_emb": "column_wise",
        "cat_2_emb": "row_wise", "cat_3_emb": "table_wise",
        "cat_4_emb": "row_wise", "cat_5_emb": "data_parallel",
        "cat_0_emb__wide": "data_parallel", "cat_1_emb__wide": "row_wise",
        "cat_2_emb__wide": "column_wise", "cat_3_emb__wide": "table_wise",
        "cat_4_emb__wide": "column_wise", "cat_5_emb__wide": "row_wise"}
ADAM = "adam_optimizer { lr: 0.01 eps: 1e-4 } constant_learning_rate {}"


def _zch_deepfm_text(**kw):
    text = deepfm_config_text(dense_opt=ADAM, **kw)
    for i, zch in DEEPFM_ZCH.items():
        text = text.replace(
            f'feature_name: "cat_{i}" num_buckets: {DEEPFM_BUCKETS[i]}',
            f'feature_name: "cat_{i}" {zch}')
    return text


def _one_rank_reference(text, canon, steps_cols, eval_cols):
    """The port at world size 1 over the global batches: (state_dict,
    spill state, losses, predictions)."""
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in canon.items()})
    tx, dense_sched = port_main._dense_optimizer(model, cfg.train_config)
    state = port_main._init_state(model, tx)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    parser = DataParser(features, labels=["label"])
    losses = []
    for cols in steps_cols:
        state, metrics = step(state, parser.parse_to_batch(cols))
        losses.append(float(metrics["total_loss"]))
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    preds = port_main.make_eval_step(model, with_loss=False)(
        DataParser(features, labels=[]).parse_to_batch(eval_cols))[0]
    return (sd, model.embedding_group.spill_state_dict(), losses,
            {k: v.numpy() for k, v in preds.items()})


# --- write_logical_rows under every layout -----------------------------------

def _write_case():
    """(the tables of the engine tests, ids of ``t_a`` with a duplicate
    and a -1, the rows to write)."""
    r = np.random.default_rng(11)
    canon = {n: r.normal(size=(rows, d)).astype(np.float32)
             for n, rows, d in R.ENGINE_TABLES}
    ids = np.asarray([3, 117, 60, 3, -1, 0, 59, 61], np.int64)
    return canon, ids, r.normal(size=(len(ids), 16)).astype(np.float32)


def _one_rank_writes(canon, ids, rows):
    from torcheasyrec_tpu_torch.parallel.emb_engine import EmbeddingEngine

    eng = R.port_engine("rowwise_adagrad", {"lr": 0.1}, "", True)
    tables = eng.init_tables(torch.Generator().manual_seed(0))
    for name, w in canon.items():
        eng.write_table(tables, name, torch.from_numpy(w))
    gk, off, _ = eng.table_rows("t_a")
    EmbeddingEngine.write_logical_rows(
        eng, tables[gk], eng.groups[gk], torch.from_numpy(ids) + off,
        torch.from_numpy(rows))
    return {n: eng.extract_table(tables, n).numpy()
            for n, _, _ in R.ENGINE_TABLES}


@pytest.mark.parametrize("layout", R.WRITE_LAYOUTS)
def test_write_logical_rows_under_every_layout(layout, runs):
    """Every rank passes the same rows; each writes what it holds: the
    gathered tables equal a one-rank engine's after the same write
    (which tests/test_torch_port_zch_spill.py holds against the JAX
    engine's), the last duplicate winning; a packed block's rows go
    through the row write, at most one call a rank."""
    canon, ids, rows = _write_case()
    ref = _one_rank_writes(canon, ids, rows)
    expect = canon["t_a"].copy()
    for i, r in zip(ids, rows):
        if i >= 0:
            expect[i] = r
    np.testing.assert_array_equal(ref["t_a"], expect)
    n_calls = []
    for rank in runs["writes"]:
        got, packed, calls = rank[layout]
        for n, v in ref.items():
            np.testing.assert_array_equal(got[n], v, err_msg=(layout, n))
        assert packed == (layout in ("row_wise", "table_wise"))
        n_calls.append(len(calls))
    if layout in ("row_wise", "table_wise"):
        assert max(n_calls) == 1 and sum(n_calls) >= 1, n_calls
    else:
        assert n_calls == [0, 0]


# --- the entry points ----------------------------------------------------------

ENTRY_ROWS = (160, 160)
ENTRY_EVAL = (64, 64)


def _entry_config(root):
    paths = {}
    for kind, sizes, seed in (("train", ENTRY_ROWS, 40),
                              ("eval", ENTRY_EVAL, 60)):
        paths[kind] = []
        for i, n in enumerate(sizes):
            path = str(root / f"{kind}_{i}.parquet")
            pq.write_table(pa.table(deepfm_cols(n, seed + i)), path)
            paths[kind].append(path)
    model_dir = str(root / "model")
    text = _zch_deepfm_text(
        batch_size=DEEPFM_B, model_dir=model_dir, num_steps=4,
        train_extra="  save_checkpoints_steps: 2\n  use_tensorboard: false")
    text = text.replace('train_input_path: "unused"',
                        f'train_input_path: "{",".join(paths["train"])}"')
    text = text.replace('eval_input_path: "unused"',
                        f'eval_input_path: "{",".join(paths["eval"])}"')
    cfg_path = str(root / "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    return cfg_path, model_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks; the references computed meanwhile."""
    remap_batches = {c: _remap_batches(i) for i, c in enumerate(REMAP_CASES)}
    remap_cases = [(REMAP_CASES[c][0], remap_batches[c], TRAIN_FLAGS)
                   for c in REMAP_CASES]
    text = _zch_deepfm_text(batch_size=DEEPFM_B)
    canon = {k: v.detach().numpy() for k, v in port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu")[0].state_dict().items()}
    steps_cols = [deepfm_cols(DEEPFM_B, 10 + i) for i in range(3)]
    eval_cols = deepfm_cols(24, 99)
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    cfg_path, model_dir = _entry_config(tmp_path_factory.mktemp("entry"))
    job = dist_util.start_ranks(
        R.zch_ranks_rank, 2,
        (remap_cases, (text, PLAN, canon, steps_cols, eval_cols, ckpt_dir),
         (cfg_path, 2), _write_case()),
        store_dir=str(tmp_path_factory.mktemp("store")), device="cpu",
        timeout_s=300)
    refs = {c: _jax_remap(REMAP_CASES[c][1], remap_batches[c])
            for c in REMAP_CASES}
    one = _one_rank_reference(text, canon, steps_cols, eval_cols)
    out = job.wait()
    return {"remap": ({c: (refs[c], [o[0][i] for o in out])
                       for i, c in enumerate(REMAP_CASES)}, remap_batches),
            "deepfm": (one, [o[1] for o in out], ckpt_dir),
            "mirror": [o[2] for o in out],
            "entry": (cfg_path, model_dir, [o[3] for o in out]),
            "writes": [o[4] for o in out],
            "routing": [o[5] for o in out]}


@pytest.mark.parametrize("case", list(REMAP_CASES))
def test_global_batch_remap_matches_jax(case, runs):
    (refs, batches) = runs["remap"][0][case], runs["remap"][1][case]
    (ref_steps, ref_state), ranks = refs
    for r, (steps, final) in enumerate(ranks):
        for i, ((a, b, rec), (ja, jb, jrec)) in enumerate(zip(steps,
                                                               ref_steps)):
            rows = R.zch_rows(REMAP_B, r)
            ends = np.concatenate([[0], np.cumsum(batches[i]["b"][1])])
            np.testing.assert_array_equal(a, ja[rows], err_msg=f"a {r} {i}")
            np.testing.assert_array_equal(
                b, jb[ends[rows.start]:ends[rows.stop]], err_msg=f"b {r} {i}")
            if case == "admission" and TRAIN_FLAGS[i]:
                for k, v in jrec.items():
                    np.testing.assert_array_equal(rec[k], v,
                                                  err_msg=f"{k} {r} {i}")
        assert set(final) == set(ref_state)
        for k, v in ref_state.items():
            np.testing.assert_array_equal(final[k], v, err_msg=f"{k} {r}")
    assert int((ref_state["keys"] >= 0).sum()) > SIZE // 2


def test_zch_deepfm_at_world_2_matches_one_rank(runs):
    (sd1, spill1, losses1, _), ranks, _ = runs["deepfm"]
    sd0, spill0, losses0, _, _, _ = ranks[0]
    assert set(sd0) == set(sd1)
    for k, v in sd1.items():
        if ".zch." in k:
            np.testing.assert_array_equal(sd0[k], v, err_msg=k)
        else:
            assert_close_to_max(sd0[k], v, k, TOL)
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[0][k], sd0[k], err_msg=k)
    np.testing.assert_allclose(losses0, losses1, rtol=TOL * 10)
    assert set(spill0) == set(spill1) == {"cat_4_emb", "cat_5_emb"}
    for t in spill1:
        a, b = spill0[t], spill1[t]
        oa, ob = np.argsort(a["keys"]), np.argsort(b["keys"])
        for k in ("keys", "stamps", "homes"):
            np.testing.assert_array_equal(a[k][oa], b[k][ob], err_msg=k)
        assert_close_to_max(a["rows"][oa], b["rows"][ob], t, TOL)
        np.testing.assert_array_equal(a["meta"], b["meta"])
    restored = [sum(r.get("cat_4_emb", (0, 0))[0] for r in rank[4])
                for rank in ranks]
    crossed = [sum(r.get("cat_4_emb", (0, 0))[1] for r in rank[4])
               for rank in ranks]
    assert sum(restored) > 0 and len(spill1["cat_4_emb"]["keys"]) > 0
    assert sum(crossed) <= sum(restored)


def test_checkpoint_between_world_sizes_predicts_alike(runs):
    (_, _, _, preds1), ranks, ckpt_dir = runs["deepfm"]
    p2 = [rank[3] for rank in ranks]
    ref = p2[0][0]
    for k, v in ref.items():
        for r, preds in enumerate(p2):
            for j, p in enumerate(preds):
                np.testing.assert_array_equal(p[k], v, err_msg=(k, r, j))
        assert_close_to_max(v, preds1[k], k, TOL)
    assert len(p2[0]) == 3 and len(p2[1]) == 2  # rank 0 ran world size 1
    w1 = torch.load(checkpoint_util.latest_checkpoint(ckpt_dir + "/w1"),
                    weights_only=True)["zch_spill"]
    for rank in ranks:
        again = rank[5]
        for t, part in w1.items():
            for k, v in part.items():
                np.testing.assert_array_equal(again[t][k], v.numpy(),
                                              err_msg=(t, k))


def test_spill_restore_row_wise_ranks(runs):
    (ok, slot, off, local_rows, _, seen, new_slot, got, _) = runs["mirror"][0]
    assert ok
    v = np.linspace(3.0, 4.0, 8, dtype=np.float32)
    holders = [r for r, m in enumerate(runs["mirror"]) if m[5][-1][1]]
    owner = (off + slot) // local_rows
    assert holders == [owner], (holders, owner)
    np.testing.assert_array_equal(runs["mirror"][owner][5][-1][2], v)
    assert new_slot >= 0
    for m in runs["mirror"]:
        assert m[6] == new_slot
        np.testing.assert_array_equal(m[7], v)
    sent = [len(m[8]) for m in runs["mirror"]]
    assert sent[owner] >= 1


def test_restores_travel_to_the_slot_owner(runs):
    """Each rank restores keys from its own store into slots the other
    rank holds, two of them into one slot: every row lands on its slot's
    owner, the one of the later position in the record winning, as one
    rank's write would order them."""
    for got, want in runs["routing"]:
        np.testing.assert_array_equal(got, want)


def test_train_evaluate_and_resume_at_world_2(runs):
    cfg_path, model_dir, out = runs["entry"]
    assert [int(first["step"]) for first, _, _ in out] == [2, 2]
    assert [int(again["step"]) for _, again, _ in out] == [4, 4]
    assert out[0][2]["auc"] == out[1][2]["auc"]
    one = port_main.evaluate(cfg_path, device="cpu")
    assert abs(one["auc"] - out[0][2]["auc"]) <= 1e-6
    ckpt = torch.load(checkpoint_util.latest_checkpoint(model_dir),
                      weights_only=True)
    assert ckpt["step"] == 4 and set(ckpt["zch_spill"]) == {"cat_4_emb",
                                                          "cat_5_emb"}
    assert any(".zch." in k for k in ckpt["model"])

"""Two-tower retrieval and the negative samplers of the port against the
JAX package (fp32, CPU; one config text, the same item and edge files and
the same Arrow columns for both; the JAX weights cross through
utils/convert.py).

- ``AliasTable`` draws, and the four samplers' output columns (with the
  hard negatives' indices) over three batches, identical to the JAX
  package's; the sampled negatives avoid what each sampler excludes.
- A parsed batch with B + S item rows (positives, then the shared
  negatives) and B user rows, identical field for field; the features'
  data groups; the loader's batches in train, eval (``num_eval_sample``)
  and predict mode (no sampler).
- ``MatchModel._sim`` with sampled, in-batch and hard negatives (empty
  hard slots included) within rtol 1e-5 / atol 1e-6.
- Per model (DSSM with INNER_PRODUCT, COSINE and in-batch negatives,
  DSSMV2 with hard negatives, DAT, MIND with CONCAT and SUM over
  histories of length 1 to ``max_seq_len``): the forward within rtol
  1e-5 / atol 1e-6; two train steps (losses, every dense parameter with
  MIND's ``routing_logits``, the tables and their row state) within rtol
  1e-4 / atol 1e-5; recall@1 and recall@5 within 1e-12.
- ``RecallAtK`` with ties (a tie counts against the positive).
- ``train_and_evaluate`` of DSSM in both packages (the sampler's file set
  through ``edit_config_json``): the same metric names, values within
  rtol 1e-4; ``predict_checkpoint`` equal to the eval step.
- The dssm config copy equals the JAX original but for its paths and
  builds at full width.

The JAX engine's co-keyed table merge is off and its dense lane takes
the tables of at most ``ZOO_DENSE_LANE`` rows, as the port's: the
200-row ``item_id_emb`` table takes the sorted row write."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import (
    ZOO_DENSE_LANE,
    converted_state,
    jax_model_and_state,
    jax_train_setup,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu import metrics as jax_metrics
from torcheasyrec_tpu.datasets import sampler as jax_sampler
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.datasets.utils import (
    HARD_NEG_INDICES as JAX_HARD_NEG_INDICES,
)
from torcheasyrec_tpu.models.match_model import MatchModel as JaxMatchModel
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch import metrics
from torcheasyrec_tpu_torch.datasets import sampler
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.datasets.dataset import (
    create_dataloader,
    create_sampler,
)
from torcheasyrec_tpu_torch.datasets.utils import (
    HARD_NEG_INDICES,
    NEG_DATA_GROUP,
    Batch,
    SparseField,
)
from torcheasyrec_tpu_torch.models.match_model import MatchModel
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    create_dense_optimizer,
)
from torcheasyrec_tpu_torch.protos import pipeline_pb2 as port_pb2
from torcheasyrec_tpu_torch.utils import convert
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 32
N_STEPS = 2
EVAL_ROWS = 1000
N_ITEMS, N_USERS, N_AUG_USER, N_AUG_ITEM = 200, 20, 30, 40
SEQ_LEN = 6
NUM_SAMPLE, NUM_EVAL_SAMPLE, NUM_HARD = 12, 16, 2
LABELS = ["pos_label"]
# the eps of adam and adagrad in the parity configs (the published ones
# keep 1e-8 and 1e-10). Some gradients are zero by construction, so both
# packages see only their rounding noise: the item tower's output bias is
# shared by every item row of a user's softmax, whose probabilities sum
# to one; a history item's row where MIND's routing passes nothing on.
# At the default eps both optimizers turn noise of 1e-10 to 1e-7 into
# steps of up to their lr, whose signs need not agree; at 1e-4 the noise
# moves a weight by less than 1e-6 a step, while a real gradient (1e-5
# and up) still moves it
OPT_EPS = 1e-4
TABLES = ["user_taste_emb", "item_id_emb", "item_cluster_emb"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = os.path.join(REPO, "torcheasyrec_tpu_torch", "benchmark",
                            "configs")
JAX_CONFIGS = os.path.join(REPO, "torcheasyrec_tpu", "benchmark", "configs")


@pytest.fixture(scope="module")
def jax_engine_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TZREC_TABLE_MERGE", "0")
        mp.setenv("TZREC_DENSE_LANE", str(ZOO_DENSE_LANE))
        mp.setenv("TZREC_PACKED", "1")
        yield


# --- data: the item table, the edge files, the batches ---------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The sampler's item file (id | weight | attrs ``id:cluster:aug``,
    some weights 0), a positive-edge file of every user and a hard-edge
    file of some users (some with fewer than ``NUM_HARD`` items, two
    with unknown items), in the graph layout both packages read."""
    root = tmp_path_factory.mktemp("match")
    r = np.random.default_rng(21)
    ids = np.arange(N_ITEMS)
    weights = r.uniform(0.5, 2.0, N_ITEMS)
    weights[r.choice(N_ITEMS, 15, replace=False)] = 0.0
    items = os.path.join(root, "items.parquet")
    pq.write_table(pa.table({
        "id": pa.array(ids), "weight": pa.array(weights),
        "attrs": pa.array([f"{i}:{i // 10}:{i % N_AUG_ITEM}" for i in ids]),
    }), items)
    pos_u = np.repeat(np.arange(N_USERS), 15)
    pos_i = r.integers(0, N_ITEMS, pos_u.size)
    pos = os.path.join(root, "pos_edges.parquet")
    pq.write_table(pa.table({"user": pa.array(pos_u), "item": pa.array(pos_i),
                             "weight": pa.array(np.ones(pos_u.size))}), pos)
    hard_u, hard_i = [], []
    for u in range(0, N_USERS, 2):
        k = int(r.integers(1, 5))
        hard_u += [u] * k
        hard_i += list(r.integers(0, N_ITEMS, k))
    hard_u += [3, 3]
    hard_i += [N_ITEMS + 5, N_ITEMS + 9]  # not in the item table
    hard = os.path.join(root, "hard_edges.parquet")
    pq.write_table(pa.table({"user": pa.array(hard_u),
                             "item": pa.array(hard_i),
                             "weight": pa.array(np.ones(len(hard_u)))}), hard)
    return {"root": str(root), "items": items, "pos": pos, "hard": hard}


def match_cols(n: int, seed: int):
    """Retrieval columns: the user's taste, a dense feature, the positive
    item (within the taste's cluster most of the time), its cluster, the
    augment ids of DAT and a click history of 1 to ``SEQ_LEN`` + 2 items
    (row 0 of length 1, row 1 of ``SEQ_LEN``)."""
    r = np.random.default_rng(seed)
    taste = r.integers(0, N_USERS, n)
    item = np.where(r.random(n) < 0.8, taste * 10 + r.integers(0, 10, n),
                    r.integers(0, N_ITEMS, n))
    lens = r.integers(1, SEQ_LEN + 3, n)
    lens[:2] = [1, SEQ_LEN]
    return {
        "user_taste": pa.array(taste),
        "int_0": pa.array(r.normal(size=n).astype(np.float32)),
        "item_id": pa.array(item),
        "item_cluster": pa.array(item // 10),
        "user_aug": pa.array(r.integers(0, N_AUG_USER, n)),
        "item_aug": pa.array(item % N_AUG_ITEM),
        "click_seq": pa.array([
            ";".join(map(str, taste[i] * 10 + r.integers(0, 10, k)))
            for i, k in enumerate(lens)]),
        "pos_label": pa.array(np.ones(n, np.float32)),
    }


# --- the configs -----------------------------------------------------------

_ATTRS = ('attr_fields: "item_id" attr_fields: "item_cluster"'
          ' attr_fields: "item_aug"')
_COMMON = (f'num_sample: {NUM_SAMPLE} {_ATTRS} item_id_field: "item_id" '
           f"num_eval_sample: {NUM_EVAL_SAMPLE}")
SAMPLERS = {
    "negative_sampler": "negative_sampler {{ input_path: \"{items}\" "
                        + _COMMON + " }}",
    "negative_sampler_v2": (
        "negative_sampler_v2 {{ user_input_path: \"unused\" "
        "item_input_path: \"{items}\" pos_edge_input_path: \"{pos}\" "
        + _COMMON + ' user_id_field: "user_taste" }}'),
    "hard_negative_sampler": (
        "hard_negative_sampler {{ user_input_path: \"unused\" "
        "item_input_path: \"{items}\" hard_neg_edge_input_path: \"{hard}\" "
        f"num_hard_sample: {NUM_HARD} " + _COMMON
        + ' user_id_field: "user_taste" }}'),
    "hard_negative_sampler_v2": (
        "hard_negative_sampler_v2 {{ user_input_path: \"unused\" "
        "item_input_path: \"{items}\" pos_edge_input_path: \"{pos}\" "
        "hard_neg_edge_input_path: \"{hard}\" "
        f"num_hard_sample: {NUM_HARD} " + _COMMON
        + ' user_id_field: "user_taste" }}'),
}


def _group(name, feats, kind="DEEP"):
    names = "".join(f'    feature_names: "{f}"\n' for f in feats)
    return (f'  feature_groups {{\n    group_name: "{name}"\n{names}'
            f"    group_type: {kind}\n  }}\n")


_TOWERS = ('user_tower { input: "user" mlp { hidden_units: [16, 8] } }'
           ' item_tower { input: "item" mlp { hidden_units: [16, 8] } }'
           " output_dim: 8 temperature: 0.2")
_UI = _group("user", ["user_taste", "int_0"]) + _group(
    "item", ["item_id", "item_cluster"])
_MIND_GROUPS = _UI + _group("hist", ["click_seq"], "SEQUENCE")


def _mind(user: str, extra: str = "") -> str:
    return ("mind { user_tower { input: \"user\" history_input: \"hist\" "
            + user + " }"
            ' item_tower { input: "item" mlp { hidden_units: [16] } }'
            f" output_dim: 8 simi_pow: 10 temperature: 0.2 {extra}}}")


# key -> (groups, model block, sampler, class name)
MATCH_MODELS = {
    "dssm": (_UI, f"dssm {{ {_TOWERS} }}", "negative_sampler", "DSSM"),
    "dssm_cosine": (_UI, f"dssm {{ {_TOWERS} similarity: COSINE }}",
                    "negative_sampler_v2", "DSSM"),
    "dssm_in_batch": (_UI, f"dssm {{ {_TOWERS} in_batch_negative: true }}",
                      "negative_sampler", "DSSM"),
    "dssm_v2_hard": (_UI, f"dssm_v2 {{ {_TOWERS} }}",
                     "hard_negative_sampler_v2", "DSSMV2"),
    "dat": (
        _UI + _group("user_aug", ["user_aug"])
        + _group("item_aug", ["item_aug"]),
        'dat { user_tower { input: "user" augment_input: "user_aug"'
        " mlp { hidden_units: [16, 8] } }"
        ' item_tower { input: "item" augment_input: "item_aug"'
        " mlp { hidden_units: [16, 8] } }"
        " output_dim: 8 temperature: 0.2 amm_i_weight: 0.5"
        " amm_u_weight: 0.3 }", "negative_sampler", "DAT"),
    "mind_concat": (
        _MIND_GROUPS,
        _mind("user_mlp { hidden_units: [12] } user_seq_combine: CONCAT"
              f" capsule_config {{ max_k: 3 max_seq_len: {SEQ_LEN}"
              " high_dim: 8 }"
              " concat_mlp { hidden_units: [16] }"),
        "negative_sampler", "MIND"),
    "mind_sum": (
        _MIND_GROUPS,
        _mind("user_mlp { hidden_units: [8] } hist_seq_mlp {"
              " hidden_units: [8] } user_seq_combine: SUM"
              f" capsule_config {{ max_k: 3 max_seq_len: {SEQ_LEN}"
              " high_dim: 8 num_iters: 2 routing_logits_scale: 5"
              " squash_pow: 2 }"
              " concat_mlp { hidden_units: [16, 8] }",
              "similarity: INNER_PRODUCT"),
        "negative_sampler", "MIND"),
}


def match_config_text(model: str, files, batch_size: int = BATCH,
                      model_dir: str = "unused", num_steps: int = 0,
                      train_path: str = "unused", eval_path: str = "unused",
                      train_extra: str = "", sampler_name: str = "",
                      opt_eps=OPT_EPS) -> str:
    """The retrieval config of ``model`` (a ``MATCH_MODELS`` key) at the
    small size, fp32, sparse adagrad and dense adam as in dssm.config
    (both eps ``opt_eps``; None keeps the published defaults)."""
    groups, block, default_sampler, _ = MATCH_MODELS[model]
    eps = "" if opt_eps is None else f" eps: {opt_eps}"
    samp = SAMPLERS[sampler_name or default_sampler].format(**files)
    feats = [
        'id_feature { feature_name: "user_taste" expression: '
        f'"user:user_taste" num_buckets: {N_USERS} embedding_dim: 8 }}',
        'raw_feature { feature_name: "int_0" expression: "user:int_0" }',
        'id_feature { feature_name: "item_id" expression: "item:item_id" '
        f"num_buckets: {N_ITEMS} embedding_dim: 8 }}",
        'id_feature { feature_name: "item_cluster" expression: '
        f'"item:item_cluster" num_buckets: {N_ITEMS // 10} '
        "embedding_dim: 4 }",
    ]
    if "user_aug" in groups:
        feats += [
            'id_feature { feature_name: "user_aug" expression: '
            f'"user:user_aug" num_buckets: {N_AUG_USER} embedding_dim: 4 }}',
            'id_feature { feature_name: "item_aug" expression: '
            f'"item:item_aug" num_buckets: {N_AUG_ITEM} embedding_dim: 12 }}']
    if "click_seq" in groups:
        feats.append(
            'sequence_id_feature { feature_name: "click_seq" expression: '
            f'"user:click_seq" num_buckets: {N_ITEMS} embedding_dim: 8 '
            f'sequence_length: {SEQ_LEN} embedding_name: "item_id_emb" }}')
    lines = [
        f'train_input_path: "{train_path}"',
        f'eval_input_path: "{eval_path}"',
        f'model_dir: "{model_dir}"',
        "train_config {",
        f"  sparse_optimizer {{ adagrad_optimizer {{ lr: 0.05{eps} }}"
        " constant_learning_rate {} }",
        f"  dense_optimizer {{ adam_optimizer {{ lr: 0.001{eps} }}"
        " constant_learning_rate {} }",
        f"  num_steps: {num_steps}" if num_steps else "  num_epochs: 1",
        train_extra,
        "}",
        "data_config {",
        f"  batch_size: {batch_size}",
        "  dataset_type: ParquetDataset",
        "  fg_mode: FG_NONE",
        '  label_fields: "pos_label"',
        f"  {samp}",
        "}",
    ]
    lines += [f"feature_configs {{ {f} }}" for f in feats]
    lines.append(
        "model_config {\n" + groups + "  " + block + "\n"
        "  metrics { recall_at_k { top_k: 1 } }\n"
        "  metrics { recall_at_k { top_k: 5 } }\n"
        "  losses { softmax_cross_entropy {} }\n}")
    return "\n".join(lines)


def _table_names(model: str):
    groups = MATCH_MODELS[model][0]
    return TABLES + (["user_aug_emb", "item_aug_emb"]
                     if "user_aug" in groups else [])


def _port_model(text):
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, dense_lane_rows=ZOO_DENSE_LANE)
    return cfg, model, features, sparse_sched


def _samplers(text, mode="train"):
    """(JAX sampler, port sampler) of the config text's data_config."""
    jcfg = text_format.Parse(text, jax_pb2.EasyRecConfig()).data_config
    which = jcfg.WhichOneof("sampler")
    sub = getattr(jcfg, which)
    js = jax_sampler.BaseSampler.create_class(type(sub).__name__)(
        sub, batch_size=BATCH, is_training=mode == "train")
    ps = create_sampler(parse_pipeline_config(text).data_config, mode)
    return js, ps


def _assert_same_columns(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        if k in (HARD_NEG_INDICES, JAX_HARD_NEG_INDICES):
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k].equals(ref[k]), k


def _ids(col):
    return np.asarray(col.cast(pa.int64()).to_numpy(zero_copy_only=False))


# --- the samplers ----------------------------------------------------------


def test_alias_table_draws_match_jax():
    w = np.random.default_rng(2).exponential(size=500)
    w[::7] = 0.0
    ours, ref = sampler.AliasTable(w), jax_sampler.AliasTable(w)
    np.testing.assert_array_equal(ours._prob, ref._prob)
    np.testing.assert_array_equal(ours._alias, ref._alias)
    a = ours.sample(20000, np.random.default_rng(9))
    b = ref.sample(20000, np.random.default_rng(9))
    np.testing.assert_array_equal(a, b)
    assert not np.isin(a, np.flatnonzero(w == 0)).any()
    # the draws follow the weights
    freq = np.bincount(a, minlength=500) / a.size
    assert np.abs(freq - w / w.sum()).max() < 0.01


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_columns_match_jax(name, files):
    text = match_config_text("dssm", files, sampler_name=name)
    js, ps = _samplers(text)
    for i in range(3):
        cols = match_cols(BATCH, seed=30 + i)
        ref = js.process(dict(cols))
        got = ps.process(dict(cols))
        _assert_same_columns(got, ref)
        n_hard = BATCH * NUM_HARD if name.startswith("hard") else 0
        for f in ("item_id", "item_cluster", "item_aug"):
            assert len(got[f]) == BATCH + NUM_SAMPLE + n_hard, f
            assert got[f].slice(0, BATCH).equals(cols[f]), f
        assert len(got["user_taste"]) == BATCH
        neg = _ids(got["item_id"])[BATCH:BATCH + NUM_SAMPLE]
        # the attributes of one item row stay together
        np.testing.assert_array_equal(
            _ids(got["item_cluster"])[BATCH:], _ids(got["item_id"])[BATCH:]
            // 10)
        if name == "negative_sampler":
            # drawn again twice at most: none gets through at this seed
            assert not np.isin(neg, _ids(cols["item_id"])).any()
        if name == "negative_sampler_v2":
            # exact: the rest comes from the weights without them
            edges = pq.read_table(files["pos"])
            banned = _ids(edges.column(1))[np.isin(
                _ids(edges.column(0)), _ids(cols["user_taste"]))]
            assert not np.isin(neg, banned).any()
        if n_hard:
            idx = got[HARD_NEG_INDICES]
            assert idx.dtype == np.int32 and idx.shape == (n_hard, 2)
            hard_items = _ids(got["item_id"])[BATCH + NUM_SAMPLE:]
            edges = pq.read_table(files["hard"])
            eu, ei = _ids(edges.column(0)), _ids(edges.column(1))
            users = _ids(cols["user_taste"])
            for (row, col), item in zip(idx, hard_items):
                if row == BATCH:
                    assert col == 0 and item == 0  # an empty slot
                else:
                    assert item in ei[eu == users[row]]
            filled = idx[:, 0] < BATCH
            assert 0 < filled.sum() < n_hard


def test_parsed_batch_with_negatives_matches_jax(files):
    """Item-side features parse B + S rows, user-side ones B; the port's
    batch equals the JAX parser's field for field; the features' data
    groups agree."""
    text = match_config_text("mind_concat", files,
                             sampler_name="hard_negative_sampler_v2")
    _, jmodel, jfeatures, _, _ = jax_model_and_state(text)
    cfg, model, features, _ = _port_model(text)
    assert [f.data_group for f in features] == [
        f.data_group for f in jfeatures]
    assert [f.name for f in features if f.data_group == NEG_DATA_GROUP] == [
        "item_id", "item_cluster"]
    js, ps = _samplers(text)
    cols = match_cols(BATCH, seed=40)
    jcols, pcols = js.process(dict(cols)), ps.process(dict(cols))
    jidx, pidx = jcols.pop(JAX_HARD_NEG_INDICES), pcols.pop(HARD_NEG_INDICES)
    np.testing.assert_array_equal(pidx, jidx)
    jbatch = JaxParser(jfeatures, labels=LABELS).parse_to_batch(jcols)
    batch = DataParser(features, labels=LABELS).parse_to_batch(pcols)
    n_item = BATCH + NUM_SAMPLE + BATCH * NUM_HARD
    assert tuple(batch.sparse_features["item_id"].values.shape) == (n_item, 1)
    assert tuple(batch.sparse_features["user_taste"].values.shape) == (
        BATCH, 1)
    assert tuple(batch.labels["pos_label"].shape) == (BATCH,)
    for kind in ("sparse_features", "sequence_sparse_features",
                 "dense_features"):
        ours, ref = getattr(batch, kind), getattr(jbatch, kind)
        assert set(ours) == set(ref), kind
        for name, field in ours.items():
            for attr in ("values", "lengths", "weights"):
                a, b = getattr(field, attr, None), getattr(ref[name], attr,
                                                           None)
                assert (a is None) == (b is None), (name, attr)
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                                  err_msg=f"{name}.{attr}")
    np.testing.assert_array_equal(batch.labels["pos_label"].numpy(),
                                  np.asarray(jbatch.labels["pos_label"]))
    # the engine and assemble take each group at its own row count
    with torch.no_grad():
        grouped = model.embedding_group(batch, torch.float32)
    assert tuple(grouped["user"].shape) == (BATCH, 9)
    assert tuple(grouped["item"].shape) == (n_item, 12)
    assert tuple(grouped["hist.sequence"].shape) == (BATCH, SEQ_LEN, 8)


def _write_match_files(root, files):
    for i, n in enumerate((100, 92)):
        pq.write_table(pa.table(match_cols(n, seed=50 + i)),
                       os.path.join(root, f"train-{i}.parquet"))
    pq.write_table(pa.table(match_cols(EVAL_ROWS, seed=60)),
                   os.path.join(root, "eval.parquet"))


@pytest.fixture(scope="module")
def data_dir(files):
    _write_match_files(files["root"], files)
    return files["root"]


@pytest.mark.parametrize("mode,sampler_name", [
    ("train", "hard_negative_sampler_v2"), ("eval", "negative_sampler"),
    ("predict", "negative_sampler")])
def test_loader_batches_carry_the_samplers_rows(mode, sampler_name, files,
                                                data_dir):
    """The loader runs the sampler in train and eval mode (num_eval_sample
    rows outside train) and not in predict mode; its first batch equals
    the JAX sampler's and parser's on the same rows, hard indices in
    ``batch.additional``."""
    text = match_config_text("dssm", files, sampler_name=sampler_name)
    cfg = parse_pipeline_config(text)
    _, _, jfeatures, _, _ = jax_model_and_state(text)
    features = port_main._create_features(cfg)
    path = os.path.join(data_dir, "train-0.parquet")
    dl = create_dataloader(cfg.data_config, features, path, mode=mode)
    it = dl()
    batch, info = next(iter(it))
    it.close()
    assert info.batch_size == BATCH
    n_neg = {"train": NUM_SAMPLE + BATCH * NUM_HARD, "eval": NUM_EVAL_SAMPLE,
             "predict": 0}[mode]
    assert batch.sparse_features["item_id"].values.shape[0] == BATCH + n_neg
    assert batch.sparse_features["user_taste"].values.shape[0] == BATCH
    assert ("hard_neg_indices" in batch.additional) == (mode == "train")
    if mode == "predict":
        return
    js, _ = _samplers(text, mode)
    cols = {k: v for k, v in pq.read_table(path).slice(0, BATCH).to_pydict()
            .items()}
    cols = {k: pa.array(v) for k, v in cols.items()}
    jcols = js.process(cols)
    jidx = jcols.pop(JAX_HARD_NEG_INDICES, None)
    jbatch = JaxParser(jfeatures, labels=LABELS).parse_to_batch(jcols)
    for name in ("item_id", "item_cluster", "user_taste"):
        np.testing.assert_array_equal(
            batch.sparse_features[name].values.numpy(),
            np.asarray(jbatch.sparse_features[name].values), err_msg=name)
    if jidx is not None:
        np.testing.assert_array_equal(
            batch.additional["hard_neg_indices"].numpy(), jidx)


def test_batch_additional_moves_with_the_batch():
    idx = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    batch = Batch(sparse_features={"a": SparseField(torch.zeros(2, 1))},
                  additional={"hard_neg_indices": idx})
    np_batch = batch.to_numpy()
    assert isinstance(np_batch.additional["hard_neg_indices"], np.ndarray)
    back = np_batch.from_numpy().to("cpu")
    assert torch.equal(back.additional["hard_neg_indices"], idx)
    assert sum(1 for _ in batch.tensors()) == 2


# --- the similarity --------------------------------------------------------


def _sim_inputs(case, b=6, d=5):
    r = np.random.default_rng(17)
    s = {"sampled": 7, "predict": 0, "in_batch": 0, "in_batch_sampled": 4,
         "hard": 3, "hard_only": 0}[case]
    k = 2 if case.startswith("hard") else 0
    user = r.normal(size=(b, d)).astype(np.float32)
    items = r.normal(size=(b + s + b * k, d)).astype(np.float32)
    idx = None
    if k:
        idx = np.full((b * k, 2), [b, 0], np.int32)
        for i in range(b):
            for j in range(int(r.integers(0, k + 1))):  # some slots empty
                idx[i * k + j] = (i, j)
        assert (idx[:, 0] == b).any() and (idx[:, 0] < b).any()
    return user, items, idx, case.startswith("in_batch")


@pytest.mark.parametrize("case", ["sampled", "predict", "in_batch",
                                  "in_batch_sampled", "hard", "hard_only"])
def test_sim_matches_jax(case):
    user, items, idx, in_batch = _sim_inputs(case)
    ref = np.asarray(JaxMatchModel._sim(
        types.SimpleNamespace(_in_batch_negative=in_batch),
        jnp.asarray(user), jnp.asarray(items),
        None if idx is None else jnp.asarray(idx)))
    got = MatchModel._sim(
        types.SimpleNamespace(_in_batch_negative=in_batch),
        torch.from_numpy(user), torch.from_numpy(items),
        None if idx is None else torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)
    if idx is not None:
        # the empty slots keep their fill and pass no gradient on
        assert (got.numpy() == -1e9).sum() == (idx[:, 0] == 6).sum()
        u = torch.from_numpy(user).requires_grad_(True)
        it = torch.from_numpy(items).requires_grad_(True)
        MatchModel._sim(types.SimpleNamespace(_in_batch_negative=False), u,
                        it, torch.from_numpy(idx)).clamp(min=-10).sum(
        ).backward()
        hard_rows = it.grad[len(items) - len(idx):]
        empty = torch.from_numpy(idx[:, 0] == 6)
        assert (hard_rows[empty] == 0).all()
        assert (hard_rows[~empty].abs().sum(1) > 0).all()


# --- the models ------------------------------------------------------------


def _as_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_dense_grad(jmodel, jstate, jbatch):
    """The JAX package's gradient of the loss with respect to every dense
    parameter at ``jstate`` on ``jbatch``, as a torch state_dict."""
    eval_step = jax_main.make_eval_step(jmodel, jnp.float32)

    def total(dense):
        _, losses = eval_step({"dense": dense, "tables": jstate["tables"]},
                              jbatch)
        return sum(losses.values())

    return convert.from_jax_state(
        jax.device_get(jax.grad(total)(jstate["dense"])), {})


def _match_run(key, files, opt_eps=OPT_EPS, with_grads=False):
    """One model in both packages from the JAX package's initial weights:
    the forward of one batch, then two train steps on two more, each
    batch's negatives drawn by both packages' samplers; with
    ``with_grads``, beside each step the JAX package's dense gradient at
    its start."""
    text = match_config_text(key, files, opt_eps=opt_eps)
    _, jmodel, jfeatures, jstate, jstep = jax_train_setup(text)
    cfg, model, features, sparse_sched = _port_model(text)
    tables = _table_names(key)
    model.load_state_dict(converted_state(
        jmodel, jstate["dense"], jstate["tables"], tables))
    jparser = JaxParser(jfeatures, labels=LABELS)
    parser = DataParser(features, labels=LABELS)
    js, ps = _samplers(text)

    def batches(seed):
        cols = match_cols(BATCH, seed)
        jcols, pcols = js.process(dict(cols)), ps.process(dict(cols))
        _assert_same_columns(pcols, jcols)
        jidx, pidx = (jcols.pop(JAX_HARD_NEG_INDICES, None),
                      pcols.pop(HARD_NEG_INDICES, None))
        jbatch, batch = jparser.parse_to_batch(jcols), parser.parse_to_batch(
            pcols)
        if jidx is not None:
            jbatch.additional["hard_neg_indices"] = jidx
            batch.additional["hard_neg_indices"] = torch.from_numpy(pidx)
        return jbatch, batch

    jbatch, batch = batches(3)
    jpreds, jlosses = jax_main.make_eval_step(jmodel, jnp.float32)(
        {"dense": jstate["dense"], "tables": jstate["tables"]}, jbatch)
    preds, losses_ = port_main.make_eval_step(model)(batch)

    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, list(model.parameters()))
    state = port_main._init_state(model)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    step_losses, jstep_losses, jgrads = [], [], []
    routing0 = (model.capsule.routing_logits.detach().clone()
                if hasattr(model, "capsule") else None)
    for i in range(N_STEPS):
        jb, b = batches(100 + i)
        if with_grads:
            jgrads.append(_jax_dense_grad(jmodel, jstate, jb))
        jstate, jm, _ = jstep(jstate, jb, jax.random.key(0))
        jstep_losses.append({k: float(v) for k, v in jm.items()
                             if not k.startswith("__")})
        state, m = step(state, b)
        step_losses.append({k: float(v) for k, v in m.items()})
    return dict(key=key, jmodel=jmodel, model=model, jbatch=jbatch,
                batch=batch, jpreds=_as_np(jpreds), preds=preds,
                jlosses=jlosses, losses=losses_, jstate=jstate, state=state,
                jstep_losses=jstep_losses, step_losses=step_losses,
                tables=tables, routing0=routing0, jgrads=jgrads)


@pytest.fixture(scope="module", params=sorted(MATCH_MODELS))
def match_run(request, files, jax_engine_env):
    return _match_run(request.param, files)


def test_match_model_builds_from_config_text(match_run):
    model, jmodel = match_run["model"], match_run["jmodel"]
    assert type(model).__name__ == type(jmodel).__name__ == MATCH_MODELS[
        match_run["key"]][3]
    eg, jeg = model.embedding_group, jmodel.embedding_group
    assert eg.group_names() == jeg.group_names()
    for g in eg.group_names():
        assert eg.group_dims(g) == jeg.group_dims(g), g
    assert set(eg.tables) == set(match_run["tables"])
    assert model.tower_specs() == jmodel.tower_specs()
    # item_id_emb (200 rows) is past the dense lane: the row write
    gk, _, _ = eg.engine.table_rows("item_id_emb")
    assert eg.engine.groups[gk].packed
    assert "item_id_emb" not in eg.engine.groups[gk].dense_tables


def test_match_forward_matches_jax(match_run):
    preds, jpreds = match_run["preds"], match_run["jpreds"]
    assert set(preds) == set(jpreds)
    n_item = BATCH + NUM_SAMPLE + (
        BATCH * NUM_HARD if match_run["key"].endswith("hard") else 0)
    assert preds["item_tower_emb"].shape[0] == n_item
    sim = preds["similarity"]
    want_cols = {"dssm_in_batch": BATCH + NUM_SAMPLE,
                 "dssm_v2_hard": 1 + NUM_SAMPLE + NUM_HARD}.get(
        match_run["key"], 1 + NUM_SAMPLE)
    assert tuple(sim.shape) == (BATCH, want_cols)
    for k, v in preds.items():
        assert tuple(v.shape) == jpreds[k].shape, k
        np.testing.assert_allclose(v.float().numpy(), jpreds[k], err_msg=k,
                                   **FWD_TOL)
    losses_, jlosses = match_run["losses"], match_run["jlosses"]
    assert set(losses_) == set(jlosses)
    for k in losses_:
        np.testing.assert_allclose(float(losses_[k]), float(jlosses[k]),
                                   err_msg=k, **FWD_TOL)


def _assert_steps_match(run, skip=()):
    """The losses of every step, every dense parameter but those in
    ``skip``, the tables and their row state after the steps within
    TOL."""
    for ours, ref in zip(run["step_losses"], run["jstep_losses"]):
        assert set(ours) == set(ref)
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    model, jstate = run["model"], run["jstate"]
    jdense = convert.from_jax_state(jax.device_get(jstate["dense"]), {})
    params = dict(model.named_parameters())
    assert set(params) == set(jdense)
    for n, p in params.items():
        if n not in skip:
            np.testing.assert_allclose(p.detach().numpy(), jdense[n].numpy(),
                                       err_msg=n, **TOL)
    jeng = run["jmodel"].embedding_group.engine
    eg = model.embedding_group
    fused = eg.engine_tables()
    for name in run["tables"]:
        ref = np.asarray(jeng.extract_table(jstate["tables"], name))
        got = eg.engine.extract_table(fused, name).numpy()
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)
        jst = jeng.extract_table_state(jstate["tables"],
                                       jstate["sparse_opt"], name)
        st = eg.engine.extract_table_state(
            fused, run["state"]["sparse_opt"], name)
        assert set(st) == set(jst), name
        for k in st:
            np.testing.assert_allclose(np.asarray(st[k]), np.asarray(jst[k]),
                                       err_msg=f"{name}.{k}", **TOL)
    # the negatives' and positives' item rows trained
    acc = eg.engine.extract_table_state(
        fused, run["state"]["sparse_opt"], "item_id_emb")["acc"]
    assert int((acc.abs().sum(1) > 0).sum()) > BATCH


def test_match_two_train_steps_match_jax(match_run):
    _assert_steps_match(match_run)
    if match_run["routing0"] is not None:
        # no gradient reaches the routing logits: the steps leave them
        assert torch.equal(match_run["model"].capsule.routing_logits.detach(),
                           match_run["routing0"])


# a dense parameter whose reference gradient, at some step, is below this
# share of the largest one's is at rounding level: its true gradient is 0
ZERO_GRAD_SHARE = 1e-5


def test_dssm_two_train_steps_at_published_eps_match_jax(files,
                                                        jax_engine_env):
    """DSSM at the published optimizer settings (adam eps 1e-8, adagrad
    eps 1e-10). The parameters whose JAX gradient is at rounding level
    (the item tower's output bias: every item row of a user's softmax
    shares it, and the probabilities sum to one) take steps of rounding
    noise over eps, so they are left out by that rule; every other leaf
    within TOL."""
    run = _match_run("dssm", files, opt_eps=None, with_grads=True)
    zero = set()
    for grads in run["jgrads"]:
        top = max(float(g.abs().max()) for g in grads.values())
        zero |= {n for n, g in grads.items()
                 if float(g.abs().max()) <= ZERO_GRAD_SHARE * top}
    assert zero == {"item_tower.output.bias"}, zero
    _assert_steps_match(run, skip=zero)


def test_match_metrics_match_jax(match_run):
    """recall@1 and recall@5 of both packages on the JAX predictions."""
    model, jmodel = match_run["model"], match_run["jmodel"]
    jpreds = match_run["jpreds"]
    ours, ref = model.init_metrics(), jmodel.init_metrics()
    for _ in range(2):
        model.update_metrics(
            ours, {k: torch.from_numpy(v.copy()) for k, v in jpreds.items()},
            match_run["batch"])
        jmodel.update_metrics(ref, jpreds, jax.device_get(match_run["jbatch"]))
    got, want = model.compute_metrics(ours), jmodel.compute_metrics(ref)
    assert list(got) == list(want) == ["recall@1", "recall@5"]
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_recall_at_k_ties_count_against_the_positive():
    sims = np.array([
        [0.5, 0.5, 0.1, 0.1, 0.1, 0.1],  # a tie at the top: no recall@1
        [0.9, 0.1, 0.2, 0.3, 0.4, 0.5],
        [0.2, 0.2, 0.2, 0.2, 0.2, 0.2],  # all tied: 5 at least as high
        [0.1, 0.3, 0.3, 0.3, 0.3, 0.0],  # 4 higher: within 5
        [0.0, 0.1, 0.2, 0.3, 0.4, 0.5],
    ], np.float32)
    for k, want in ((1, 0.2), (5, 0.6)):
        ours, ref = metrics.RecallAtK(top_k=k), jax_metrics.RecallAtK(top_k=k)
        ours.update(sims)
        ref.update(sims)
        ours.update(sims[1])  # a single row
        ref.update(sims[1])
        assert abs(ours.compute() - ref.compute()) <= 1e-12
        assert abs(ours.compute() - (want * 5 + 1) / 6) <= 1e-12


# --- the entry points ------------------------------------------------------


def _match_config(path, files, model_dir, root):
    text = match_config_text(
        "dssm", dict(files, items="unused_items.parquet"), batch_size=BATCH,
        model_dir=model_dir, num_steps=5,
        train_path=os.path.join(root, "train-*.parquet"),
        eval_path=os.path.join(root, "eval.parquet"),
        train_extra="  save_checkpoints_steps: 3")
    with open(path, "w") as f:
        f.write(text)
    return path, text


def _eval_lines(model_dir):
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        return [json.loads(line) for line in f]


def test_train_and_evaluate_dssm_matches_jax(files, data_dir, tmp_path,
                                             monkeypatch, jax_engine_env):
    """5 steps of 32 over two files, a save and an eval at step 3 and at
    the end, in both packages from the JAX init, the sampler's item file
    set through ``edit_config_json``; then the port's predict_checkpoint
    against its eval step."""
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    edit = json.dumps({"data_config.negative_sampler.input_path":
                       files["items"]})
    jax_dir = str(tmp_path / "jax")
    jax_cfg, text = _match_config(str(tmp_path / "jax.config"), files,
                                  jax_dir, data_dir)
    jax_main.train_and_evaluate(jax_cfg, edit_config_json=edit)

    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = str(tmp_path / "jax_init.pt")
    torch.save(converted_state(jmodel, dense, tables, TABLES), init)
    port_dir = str(tmp_path / "port")
    port_cfg, _ = _match_config(str(tmp_path / "port.config"), files,
                                port_dir, data_dir)
    result = port_main.train_and_evaluate(
        port_cfg, fine_tune_checkpoint=init, edit_config_json=edit,
        device="cpu")
    assert result["step"] == 5.0
    ours, ref = _eval_lines(port_dir), _eval_lines(jax_dir)
    assert [r["global_step"] for r in ours] == [
        r["global_step"] for r in ref] == [3, 5]
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        assert "recall@1" in a and "recall@5" in a
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
    with open(os.path.join(port_dir, "pipeline.config")) as f:
        saved = parse_pipeline_config(f.read())
    assert saved.data_config.negative_sampler.input_path == files["items"]

    # predict: no sampler, one item row a user, similarity [B, 1]
    saved_cfg = os.path.join(port_dir, "pipeline.config")
    pred_in = os.path.join(data_dir, "train-1.parquet")
    out = str(tmp_path / "pred.parquet")
    n = port_main.predict_checkpoint(saved_cfg, pred_in, out, device="cpu")
    assert n == 92
    pred = pq.read_table(out)
    assert sorted(pred.column_names) == [
        "item_tower_emb", "similarity", "user_tower_emb"]
    model, features = port_main.build_model(saved, "cpu")
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(port_dir), model)
    eval_step = port_main.make_eval_step(model, with_loss=False)
    outs = {}
    it = create_dataloader(saved.data_config, features, pred_in,
                           mode="predict")()
    for batch, _ in it:
        for k, v in eval_step(batch)[0].items():
            outs.setdefault(k, []).append(v.numpy())
    it.close()
    for k, v in outs.items():
        v = np.concatenate(v)
        assert v.shape[0] == 92 and (k != "similarity" or v.shape[1] == 1)
        np.testing.assert_array_equal(
            np.stack(pred.column(k).to_numpy(zero_copy_only=False)), v,
            err_msg=k)


# --- the config ------------------------------------------------------------


def _without_paths(text, pb2):
    cfg = text_format.Parse(text, pb2.EasyRecConfig())
    for field in ("train_input_path", "eval_input_path", "model_dir"):
        cfg.ClearField(field)
    cfg.data_config.negative_sampler.ClearField("input_path")
    return cfg.SerializePartialToString(deterministic=True)


def test_dssm_config_copy_equals_the_jax_original_but_its_paths():
    with open(os.path.join(PORT_CONFIGS, "criteo_synth", "dssm.config")) as f:
        ours = f.read()
    with open(os.path.join(JAX_CONFIGS, "criteo_synth", "dssm.config")) as f:
        ref = f.read()
    assert _without_paths(ours, port_pb2) == _without_paths(ref, jax_pb2)
    cfg = parse_pipeline_config(ours)
    assert cfg.train_input_path.startswith("criteo_synth_data/")
    assert cfg.model_dir == "criteo_synth_model/dssm"
    assert cfg.data_config.negative_sampler.input_path == (
        "criteo_synth_data/criteo_synth_items.parquet")
    with open(os.path.join(PORT_CONFIGS, "base_eval_metric.json")) as f:
        labels = json.load(f)
    with open(os.path.join(JAX_CONFIGS, "base_eval_metric.json")) as f:
        jax_labels = json.load(f)
    key = "criteo_synth/dssm.config"
    pinned = labels[f"torcheasyrec_tpu_torch/benchmark/configs/{key}"]
    assert pinned == jax_labels[f"torcheasyrec_tpu/benchmark/configs/{key}"]
    # the full-width model builds, and reports the pinned metrics
    model, features = port_main.build_model(cfg, "cpu")
    assert type(model).__name__ == "DSSM"
    assert [m["name"] for m in model.init_metrics()] == list(
        pinned["metrics"]) == ["recall@1", "recall@5"]
    eg = model.embedding_group
    assert eg.group_dims("user") == [16, 1]
    assert eg.group_dims("item") == [16, 8]
    assert [f.name for f in features if f.data_group == NEG_DATA_GROUP] == [
        "item_id", "item_cluster"]
    assert model.user_tower.output.out_features == 16
    assert [layer.linear.out_features
            for layer in model.item_tower.mlp.layers] == [64, 32]
    # every table is in the dense lane at the published width
    assert all(name in g.dense_tables for g in eg.engine.groups.values()
               for name in (t.name for t in g.specs))

"""TDM in the port against the JAX package (fp32, CPU; one config text,
the same numpy-made files and Arrow columns for both; the JAX weights
cross through utils/convert.py).

- ``init_tree`` (with and without a category column) and
  ``cluster_tree``: the node table, the edge table and the root byte for
  byte.
- ``TDMSampler`` over 3 batches: identical columns and labels;
  ``TDMPredictSampler``'s ``get_children_ids``, ``get`` and
  ``node_attr_columns`` on a tree of 3 children a node (so that the
  expansion draws): identical.
- The model on a sampled batch: the forward within rtol 1e-5 / atol
  1e-6; two train steps (losses, every dense parameter with the batch
  norms' statistics, the tables and their row state) within rtol 1e-4 /
  atol 1e-5 (adam's and rowwise adagrad's eps 1e-4: a linear's bias
  before a batch norm has a gradient at rounding level, ROADMAP §3).
- ``train_and_evaluate`` in both packages from the JAX init (the loader
  runs the sampler in train and eval): the AUCs within 1e-5.
- ``export``: ``embedding/``'s ``tower.json`` and ``fg.json`` equal to
  the JAX package's, the node embeddings that each package's ``predict``
  gives from it within 1e-5; the port's program holds the query tables
  only and equals ``node_embedding``.
- ``tdm_retrieval`` from the same weights: the same ``recall_ids`` for
  every user whose scores (the port's, recorded at each layer) hold no
  two within 1e-6, the same set of them where no two at a layer's cut
  (the kept against the dropped) are, and then the same recall.

The JAX engine's co-keyed table merge is off and its dense lane takes
tables of at most ``ZOO_DENSE_LANE`` rows, as the port's: the shared
``item_emb`` table (128 rows) takes the sorted row write."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from test_torch_port_zoo_rest import Paired
from torch_port_helpers import ZOO_DENSE_LANE, converted_state
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.datasets import sampler as jax_sampler
from torcheasyrec_tpu.protos import sampler_pb2 as jax_sampler_pb2
from torcheasyrec_tpu.tools.tdm import gen_tree as jax_gen_tree
from torcheasyrec_tpu.tools.tdm import retrieval as jax_retrieval
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets import sampler
from torcheasyrec_tpu_torch.protos import sampler_pb2
from torcheasyrec_tpu_torch.tools.tdm import gen_tree, retrieval

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
N_ITEMS, N_CLUSTERS, N_USERS, SEQ_LEN = 64, 8, 40, 10
BUCKETS = (50, 7, 30)
LAYERS = "[0, 1, 1, 2, 2, 3, 3]"  # the root, then depths 1..6 (the leaves)
BATCH = 16
TABLES = ("cat_0_emb", "cat_1_emb", "cat_2_emb", "item_emb")


def _items(path, n=N_ITEMS, seed=0):
    """An item file (id | weight | "item_id:item_cluster") with a
    shuffled id order, and a category and an embedding column."""
    r = np.random.default_rng(seed)
    ids = r.permutation(n).astype(np.int64)
    pq.write_table(pa.table({
        "id": ids, "weight": r.uniform(0.5, 2.0, n),
        "attrs": [f"{i}:{i // (n // N_CLUSTERS)}" for i in ids],
        "category": r.integers(0, 5, n),
        "embedding": list(r.normal(size=(n, 6)).astype(np.float32)),
    }), path)
    return path


def _cols(n, seed):
    """Users: three id features, two dense, the target item and a history
    of up to SEQ_LEN ids from its cluster (ids as strings, ';'-joined)."""
    r = np.random.default_rng(seed)
    per = N_ITEMS // N_CLUSTERS
    items = r.integers(0, N_ITEMS, n)
    hist = []
    for it in items:
        c = it // per
        hist.append(";".join(str(x) for x in r.integers(
            c * per, (c + 1) * per, int(r.integers(1, SEQ_LEN + 1)))))
    cols = {f"cat_{j}": pa.array(r.integers(0, b, n))
            for j, b in enumerate(BUCKETS)}
    cols.update({
        "int_0": pa.array(r.normal(size=n).astype(np.float32)),
        "int_1": pa.array(r.normal(size=n).astype(np.float32)),
        "item_id": pa.array(items), "click_seq": pa.array(hist),
        "label": pa.array(np.ones(n, np.float32)),
    })
    return cols


def _sampler_text(tree, layers=LAYERS):
    return (f'item_input_path: "{tree}/node_table.parquet" '
            f'edge_input_path: "{tree}/edge_table.parquet" '
            f'predict_edge_input_path: "{tree}/edge_table.parquet" '
            f'attr_fields: "item_id" item_id_field: "item_id" '
            f"layer_num_sample: {layers}")


def config_text(root, model_dir, num_steps=5, batch_size=BATCH):
    feats = "".join(
        f'feature_configs {{ id_feature {{ feature_name: "cat_{j}" '
        f"num_buckets: {b} embedding_dim: 8 }} }}\n"
        for j, b in enumerate(BUCKETS))
    feats += "".join(
        f'feature_configs {{ raw_feature {{ feature_name: "int_{i}" }} }}\n'
        for i in range(2))
    user = " ".join(f'feature_names: "{f}"' for f in (
        "cat_0", "cat_1", "cat_2", "int_0", "int_1"))
    return f"""train_input_path: "{root}/train.parquet"
eval_input_path: "{root}/eval.parquet"
model_dir: "{model_dir}"
train_config {{
  sparse_optimizer {{ rowwise_adagrad_optimizer {{ lr: 0.01 eps: 1e-4 }}
                      constant_learning_rate {{}} }}
  dense_optimizer {{ adam_optimizer {{ lr: 0.001 eps: 1e-4 }}
                     constant_learning_rate {{}} }}
  num_steps: {num_steps}
}}
eval_config {{}}
data_config {{
  batch_size: {batch_size}
  dataset_type: ParquetDataset
  fg_mode: FG_NONE
  label_fields: "label"
  tdm_sampler {{ {_sampler_text(root + "/tree")} }}
}}
{feats}feature_configs {{ id_feature {{ feature_name: "item_id" num_buckets: 128
  embedding_dim: 8 embedding_name: "item_emb" }} }}
feature_configs {{ sequence_id_feature {{ feature_name: "click_seq"
  num_buckets: 128 embedding_dim: 8 sequence_length: {SEQ_LEN}
  embedding_name: "item_emb" }} }}
model_config {{
  feature_groups {{ group_name: "user" {user} group_type: DEEP }}
  feature_groups {{ group_name: "seq" feature_names: "item_id"
                    feature_names: "click_seq" group_type: SEQUENCE }}
  tdm {{
    multiwindow_din {{ windows_len: [2, 3, 5]
      attn_mlp {{ hidden_units: [12] activation: "nn.PReLU" }} }}
    final {{ hidden_units: [16, 8] use_bn: true activation: "nn.PReLU" }}
  }}
  num_class: 1
  losses {{ binary_cross_entropy {{}} }}
  metrics {{ auc {{}} }}
}}
"""


@pytest.fixture(scope="module")
def jax_engine_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TZREC_DENSE_LANE", str(ZOO_DENSE_LANE))
        mp.setenv("TZREC_PACKED", "1")
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tdm"))
    items = _items(os.path.join(root, "items.parquet"))
    gen_tree.init_tree(items, os.path.join(root, "tree"))
    pq.write_table(pa.table(_cols(5 * BATCH, 1)),
                   os.path.join(root, "train.parquet"))
    pq.write_table(pa.table(_cols(N_USERS, 2)),
                   os.path.join(root, "eval.parquet"))
    return root


def _sampler_pair(tree, cls, layers=LAYERS, **kw):
    text = _sampler_text(tree, layers)
    return (getattr(jax_sampler, cls)(text_format.Parse(
                text, jax_sampler_pb2.TDMSampler()), **kw),
            getattr(sampler, cls)(text_format.Parse(
                text, sampler_pb2.TDMSampler()), **kw))


# --- the tree tools -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["init", "init_category", "cluster"])
def test_tree_tables_match_jax(tmp_path, mode):
    items = _items(str(tmp_path / "items.parquet"), n=37, seed=3)
    for pkg, out in ((jax_gen_tree, "jax"), (gen_tree, "port")):
        out = str(tmp_path / out)
        if mode == "cluster":
            pkg.cluster_tree(items, out, branching=3)
        else:
            pkg.init_tree(items, out, category_column=(
                "category" if mode == "init_category" else None))
    for f in ("node_table.parquet", "edge_table.parquet", "root_id.txt"):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    nodes = pq.read_table(tmp_path / "port" / "node_table.parquet")
    attrs = dict(zip(nodes.column("id").to_pylist(),
                     nodes.column("attrs").to_pylist()))
    # internal nodes above the largest item id, their attrs their own ids
    assert all(attrs[i] == str(i) for i in attrs if i >= 37)
    assert all(":" in attrs[i] for i in attrs if i < 37)


# --- the samplers ----------------------------------------------------------


def test_tdm_sampler_matches_jax(files):
    jax_s, port_s = _sampler_pair(os.path.join(files, "tree"), "TDMSampler",
                                  label_field="label")
    for seed in range(3):
        cols = _cols(BATCH, 10 + seed)
        cols["item_id"] = pa.array(np.asarray(  # one item outside the tree
            cols["item_id"].to_pylist()[:-1] + [999]))
        ref, got = jax_s.process(dict(cols)), port_s.process(dict(cols))
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].equals(ref[k]), k
        labels = got["label"].to_numpy()
        # each row's 6 ancestors are positives; the root takes no row
        assert int(labels.sum()) == 6 * (BATCH - 1)
    assert port_s._max_depth == jax_s._max_depth == 6


def test_tdm_predict_sampler_matches_jax(tmp_path):
    items = _items(str(tmp_path / "items.parquet"), n=40, seed=5)
    tree = str(tmp_path / "tree")
    gen_tree.init_tree(items, tree, branching=3)
    jax_s, port_s = _sampler_pair(tree, "TDMPredictSampler",
                                  is_training=False)
    edges = pq.read_table(os.path.join(tree, "edge_table.parquet"))
    parents = np.unique(edges.column("parent").to_numpy())
    ids = np.concatenate([parents, [-1, 3, 999]])
    for s in (jax_s, port_s):
        s.init_sampler(2)
    for _ in range(2):  # the expansion draws: twice, the same draws
        np.testing.assert_array_equal(port_s.get_children_ids(ids),
                                      jax_s.get_children_ids(ids))
    batch = {"item_id": pa.array(parents[:5])}
    ref, got = jax_s.get(dict(batch)), port_s.get(dict(batch))
    assert list(got) == list(ref) == ["item_id"]
    assert got["item_id"].equals(ref["item_id"])
    nodes = np.asarray([0, 5, int(parents[0]), -1, 999], np.int64)
    ref, got = (jax_s.node_attr_columns(nodes),
                port_s.node_attr_columns(nodes))
    assert got["item_id"].equals(ref["item_id"])


# --- the model -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tdm_run(files, jax_engine_env):
    """The model in both packages from the JAX initial weights: the eval
    forward of one sampled batch, then two train steps on two more."""
    _, port_s = _sampler_pair(os.path.join(files, "tree"), "TDMSampler",
                              label_field="label")
    pair = Paired(config_text(files, os.path.join(files, "unused")),
                  TABLES, ["label"],
                  lambda seed: port_s.process(_cols(BATCH, seed)))
    jbatch, batch = pair.batches(3)
    jpreds, jlosses = jax_main.make_eval_step(pair.jmodel, jnp.float32)(
        {"dense": pair.jstate["dense"], "tables": pair.jstate["tables"]},
        jbatch)
    preds, losses = port_main.make_eval_step(pair.model)(batch)
    steps = [pair.step(100 + i) for i in range(2)]
    return dict(pair=pair, jpreds={k: np.asarray(v) for k, v in
                                   jpreds.items()}, preds=preds,
                jlosses=jlosses, losses=losses, steps=steps,
                rows=batch.labels["label"].shape[0])


def test_tdm_forward_matches_jax(tdm_run):
    model, jmodel = tdm_run["pair"].model, tdm_run["pair"].jmodel
    assert type(model).__name__ == type(jmodel).__name__ == "TDM"
    assert model.seq_group == jmodel._seq_group == "seq"
    assert set(model.embedding_group.tables) == set(TABLES)
    preds, jpreds = tdm_run["preds"], tdm_run["jpreds"]
    assert set(preds) == set(jpreds) == {"logits", "probs"}
    assert tdm_run["rows"] > BATCH  # the sampler's expansion
    for k in preds:
        assert preds[k].shape[0] == tdm_run["rows"]
        np.testing.assert_allclose(preds[k].numpy(), jpreds[k], err_msg=k,
                                   **FWD_TOL)
    for k in tdm_run["jlosses"]:
        np.testing.assert_allclose(float(tdm_run["losses"][k]),
                                   float(tdm_run["jlosses"][k]), err_msg=k,
                                   **FWD_TOL)


def test_tdm_two_train_steps_match_jax(tdm_run):
    for jm, m in tdm_run["steps"]:
        assert set(jm) == set(m)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], err_msg=k, **TOL)
    tdm_run["pair"].assert_state_matches()
    sd = tdm_run["pair"].model.state_dict()
    assert any(k.endswith(".bn.mean") for k in sd)


# --- the entry points ---------------------------------------------------------


def _write_config(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


def _jax_init(text, path):
    from torch_port_helpers import jax_model_and_state

    _, jmodel, _, dense, tables = jax_model_and_state(text)
    torch.save(converted_state(jmodel, dense, tables, TABLES), path)
    return path


def test_train_and_evaluate_matches_jax(files, tmp_path, monkeypatch,
                                        jax_engine_env):
    """5 steps of 16 users through the loader and the sampler, then the
    eval pass (the sampler in eval mode), in both packages."""
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main.train_and_evaluate(_write_config(
        str(tmp_path / "jax.config"), config_text(files, jax_dir)))
    init = _jax_init(config_text(files, jax_dir), str(tmp_path / "init.pt"))
    result = port_main.train_and_evaluate(
        _write_config(str(tmp_path / "port.config"),
                      config_text(files, port_dir)),
        fine_tune_checkpoint=init, device="cpu")
    assert result["step"] == 5.0
    with open(os.path.join(jax_dir, "train_eval_result_v2.txt")) as f:
        ref = json.loads(f.readlines()[-1])
    assert 0.0 < result["auc"] < 1.0
    assert abs(result["auc"] - ref["auc"]) <= 1e-5, (result["auc"], ref)


@pytest.fixture(scope="module")
def exported(files, tmp_path_factory, jax_engine_env):
    """Both packages' export from the JAX init (no checkpoint in their
    model dirs; the port's from the converted weights)."""
    root = str(tmp_path_factory.mktemp("tdm_export"))
    text = config_text(files, os.path.join(root, "jax_model"))
    jax_cfg = _write_config(os.path.join(root, "jax.config"), text)
    jax_main.export(jax_cfg, os.path.join(root, "jax"))
    init = _jax_init(text, os.path.join(root, "init.pt"))
    port_cfg = _write_config(os.path.join(root, "port.config"), config_text(
        files, os.path.join(root, "port_model")))
    port_main.export(port_cfg, os.path.join(root, "port"),
                     checkpoint_path=init, device="cpu")
    return root


def test_tdm_export_layout_matches_jax(exported):
    for name in ("tower.json", "fg.json"):
        with open(os.path.join(exported, "jax", "embedding", name)) as a, \
                open(os.path.join(exported, "port", "embedding", name)) as b:
            assert json.load(b) == json.load(a), name
    for rel in ("embedding/tower_fn.pt2", "model/predict_fn.pt2",
                "model/pipeline.config", "model/fg.json"):
        assert os.path.exists(os.path.join(exported, "port", rel)), rel


def test_tdm_node_embeddings_match_jax(exported, files):
    nodes = os.path.join(exported, "nodes.parquet")
    n_nodes = pq.read_table(os.path.join(
        files, "tree", "node_table.parquet")).num_rows
    pq.write_table(pa.table({"item_id": pa.array(np.arange(n_nodes))}),
                   nodes)
    out = {}
    for pkg in ("jax", "port"):
        path = os.path.join(exported, f"{pkg}_emb.parquet")
        art = os.path.join(exported, pkg, "embedding")
        if pkg == "jax":
            jax_main.predict(nodes, path, art, reserved_columns="item_id")
        else:
            port_main.predict(nodes, path, art, reserved_columns="item_id",
                              device="cpu")
        t = pq.read_table(path)
        assert t.column("item_id").to_pylist() == list(range(n_nodes))
        out[pkg] = np.stack(t.column("item_emb").to_numpy(
            zero_copy_only=False))
    assert out["port"].shape == (n_nodes, 8)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=1e-5)


def test_tdm_embedding_program_holds_the_query_tables_only(exported):
    """The program's weights are the node group's (item_emb alone), and
    it gives ``node_embedding`` on its serving batch."""
    import torch.utils._pytree as pytree

    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    art = os.path.join(exported, "port", "embedding")
    program = torch.export.load(os.path.join(art, "tower_fn.pt2"))
    cfg = load_pipeline_config(os.path.join(art, "pipeline.config"))
    model, features = port_main._artifact_model(cfg, "cpu")
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    checkpoint_util.restore_model(os.path.join(art, "model"), model,
                                  strict=False)
    node = port_main._NodeEmbedding(model)
    assert set(node.embedding_group.tables) == {"item_emb"}
    weights = dict(program.state_dict)
    weights.update(program.constants)
    n_weights = sum(t.numel() for t in weights.values()
                    if isinstance(t, torch.Tensor))
    assert n_weights == sum(t.numel() for t in
                            node.embedding_group.engine_tables().values())
    _, batch = port_main.serving_batch(cfg, [
        f for f in features if f.name == "item_id"], "cpu")
    got = program.module()(*pytree.tree_flatten(batch)[0])["item_emb"]
    want = model.embedding_group.node_embedding(batch, torch.float32, "seq")
    assert torch.equal(got, want)


def test_tdm_retrieval_matches_jax(files, tmp_path, monkeypatch,
                                   jax_engine_env):
    """recall@4 (beam 8 from layer 4 of 6) and recall@32 (every leaf at
    once) from the JAX init."""
    text = config_text(files, str(tmp_path / "empty_model_dir"))
    cfg = _write_config(str(tmp_path / "tdm.config"), text)
    init = _jax_init(text, str(tmp_path / "init.pt"))
    users = os.path.join(files, "eval.parquet")
    scores = []
    make_eval_step = port_main.make_eval_step

    def recording(model, with_loss=True):
        step = make_eval_step(model, with_loss)

        def run(batch):
            preds, losses = step(batch)
            scores.append(preds["probs"].numpy().copy())
            return preds, losses
        return run

    monkeypatch.setattr(port_main, "make_eval_step", recording)
    tied_counts = {}
    for recall_num in (4, 32):
        out_j, out_p = (str(tmp_path / f"{p}_{recall_num}.parquet")
                        for p in ("jax", "port"))
        ref = jax_retrieval.tdm_retrieval(
            cfg, users, out_j, recall_num=recall_num, n_cluster=2,
            batch_size=N_USERS, reserved_columns="cat_0")
        scores.clear()
        got = retrieval.tdm_retrieval(
            cfg, users, out_p, recall_num=recall_num, n_cluster=2,
            checkpoint_path=init, batch_size=N_USERS,
            reserved_columns="cat_0", device="cpu")
        assert got["total"] == ref["total"] == N_USERS
        assert got["first_layer"] == (4 if recall_num == 4 else 6)
        assert len(scores) == 7 - got["first_layer"]
        tied, boundary = set(), set()
        for layer, s in enumerate(scores):  # [users * W], one per layer
            s = -np.sort(-s.reshape(N_USERS, -1), axis=1)
            k = recall_num if layer == len(scores) - 1 else 2 * recall_num
            tied |= set(np.flatnonzero(
                (-np.diff(s, axis=1) <= 1e-6).any(axis=1)).tolist())
            boundary |= set(np.flatnonzero(
                s[:, k - 1] - s[:, k] <= 1e-6).tolist())
        ids_j = pq.read_table(out_j).column("recall_ids").to_pylist()
        ids_p = pq.read_table(out_p).column("recall_ids").to_pylist()
        assert pq.read_table(out_p).column("cat_0").equals(
            pq.read_table(out_j).column("cat_0"))
        assert all(len(r) == recall_num for r in ids_p)
        # no two scores within 1e-6: the same list; none at a cut between
        # the kept and the dropped: the same set
        for i in range(N_USERS):
            if i not in tied:
                assert ids_p[i] == ids_j[i], i
            if i not in boundary:
                assert set(ids_p[i]) == set(ids_j[i]), i
        if not boundary:
            assert got["recall"] == ref["recall"]
        tied_counts[recall_num] = (len(tied), len(boundary))
    assert max(n for _, n in tied_counts.values()) < N_USERS // 4, tied_counts

"""Per-tower export of the port against the JAX package (CPU, fp32):
DSSM trained by the JAX package, its trained weights carried across by
utils/convert.py, then both packages export and embed the item corpus
and the users from their tower artifacts alone (as
tests/test_tower_export.py does): tower.json and fg.json equal, the
embeddings within 1e-5 of the JAX package's, the hitrate from the port's
embeddings above the JAX test's 0.4. HSTU-Match's user tower program
holds the attention operator and equals the eager tower."""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from test_hstu_match import CONFIG as HSTU_MATCH_CONFIG
from test_hstu_match import _gen_data as hstu_match_data
from test_match_integration import DSSM_CONFIG, _gen_data
from torch_port_helpers import converted_state, jax_model_and_state
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.utils import checkpoint_util as jax_ckpt
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.tools.hitrate import compute_hitrate
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

OP = "tzrec_tpu_torch.hstu_attention_fwd"


def _emb(path, key):
    t = pq.read_table(path if not os.path.isdir(path) else os.path.join(
        path, sorted(os.listdir(path))[0]))
    return t, np.stack(t[key].to_numpy(zero_copy_only=False))


def test_dssm_tower_export_matches_jax(tmp_path, monkeypatch):
    tmp_path = str(tmp_path)
    train, evalp, item = _gen_data(tmp_path)
    text = DSSM_CONFIG.format(train=train, eval=evalp,
                              model_dir=os.path.join(tmp_path, "model"),
                              item_table=item)
    cfg_path = os.path.join(tmp_path, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_main.train_and_evaluate(cfg_path)
    jax_dir = os.path.join(tmp_path, "jax_export")
    jax_main.export(cfg_path, jax_dir)

    # the JAX package's trained weights as the port's checkpoint
    _, jmodel, _, dense, tables = jax_model_and_state(text)
    sub = jax_ckpt.restore_train_state(
        jax_ckpt.latest_checkpoint(os.path.join(tmp_path, "model")), jmodel,
        {"dense": dense, "tables": tables})
    trained = os.path.join(tmp_path, "trained.pt")
    torch.save(converted_state(jmodel, sub["dense"], sub["tables"],
                               ["user_id_emb", "item_id_emb",
                                "item_cat_emb"]), trained)
    port_dir = os.path.join(tmp_path, "port_export")
    port_main.export(cfg_path, port_dir, checkpoint_path=trained,
                     device="cpu")
    for tower in ("user", "item"):
        for name in ("pipeline.config", "fg.json", "tower.json",
                     "model/model.pt", port_main.TOWER_PROGRAM,
                     port_main.SERVING_SPEC):
            assert os.path.exists(os.path.join(port_dir, tower, name)), (
                tower, name)
        for name in ("tower.json", "fg.json"):
            with open(os.path.join(port_dir, tower, name)) as f, open(
                    os.path.join(jax_dir, tower, name)) as g:
                assert json.load(f) == json.load(g), (tower, name)
    assert os.path.exists(os.path.join(port_dir, port_main.PREDICT_PROGRAM))

    item_tbl = pq.read_table(item)
    n_items = item_tbl.num_rows
    cats = np.array([int(a.split(":")[1])
                     for a in item_tbl.column("attrs").to_pylist()])
    corpus = os.path.join(tmp_path, "corpus.parquet")
    pq.write_table(pa.table({"item_id": pa.array(np.arange(n_items)),
                             "item_cat": pa.array(cats)}), corpus)
    ev = pq.read_table(evalp)
    users = np.asarray(ev.column("user_id"))
    uniq_users = np.unique(users)
    queries = os.path.join(tmp_path, "queries.parquet")
    pq.write_table(pa.table({"user_id": pa.array(uniq_users)}), queries)

    embs = {}
    for pkg, predict, root, kw in (
            ("jax", jax_main.predict, jax_dir, {}),
            ("port", port_main.predict, port_dir, {"device": "cpu"})):
        for tower, inp, key, col in (
                ("item", corpus, "item_tower_emb", "item_id"),
                ("user", queries, "user_tower_emb", "user_id")):
            out = os.path.join(tmp_path, f"{pkg}_{tower}.parquet")
            predict(inp, out, os.path.join(root, tower),
                    reserved_columns=col, **kw)
            t, e = _emb(out, key)
            embs[pkg, tower] = (np.asarray(t[col]), e)
    for tower, n in (("item", n_items), ("user", len(uniq_users))):
        (pid, pemb), (jid, jemb) = embs["port", tower], embs["jax", tower]
        assert pemb.shape == (n, 8)
        np.testing.assert_array_equal(pid, jid)
        np.testing.assert_allclose(pemb, jemb, rtol=0, atol=1e-5,
                                   err_msg=tower)

    gt_items = np.asarray(ev.column("item_id"))
    gts = [list(gt_items[users == u]) for u in uniq_users]
    item_ids, item_emb = embs["port", "item"]
    hitrate, _ = compute_hitrate(embs["port", "user"][1], gts, item_ids,
                                 item_emb, top_k=40)
    # random recall@40 over 200 items is 0.2
    assert hitrate > 0.4, hitrate


def test_hstu_match_user_tower_program_runs_the_op(tmp_path):
    """HSTU-Match's user tower (head dim 16): its tower_fn.pt2 holds one
    attention operator per STU layer and equals the eager tower on the
    traced batch; the item tower's holds none."""
    root = str(tmp_path)
    train, evalp, item = hstu_match_data(root)
    text = HSTU_MATCH_CONFIG.format(train=train, eval=evalp,
                                    model_dir=os.path.join(root, "model"),
                                    item_table=item)
    cfg_path = os.path.join(root, "pipeline.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    export_dir = os.path.join(root, "export")
    port_main.export(cfg_path, export_dir, device="cpu")
    cfg = parse_pipeline_config(text)
    # the export's model: the seeded init, the trainer's layout
    model, features = port_main._artifact_model(cfg, torch.device("cpu"))
    n_layers = sum(1 for m in model.modules()
                   if type(m).__name__ == "STULayer")
    assert n_layers >= 1
    for tower, want in (("user", n_layers), ("item", 0)):
        tdir = os.path.join(export_dir, tower)
        program = torch.export.load(os.path.join(tdir,
                                                 port_main.TOWER_PROGRAM))
        ops = [n for n in program.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(OP)]
        assert len(ops) == want, tower
        with open(os.path.join(tdir, "tower.json")) as f:
            meta = json.load(f)
        feats = [f for f in features if f.name in set(meta["features"])]
        _, batch = port_main.serving_batch(cfg, feats, "cpu")
        got = program.module()(*torch.utils._pytree.tree_flatten(batch)[0])
        fn = port_main._tower_fn(model, tower, meta["groups"],
                                 meta["output"])
        with torch.inference_mode():
            ref = fn(batch)
        assert torch.equal(got[meta["output"]], ref[meta["output"]]), tower

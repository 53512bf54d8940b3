"""The port's host-offloaded tables (``host_offload``: weights and row
state in host memory, the batch's rows to the device, the row gradients
back, the optimizer on the host), on the CPU:

- a host engine's lookups and three updates under sgd, adagrad,
  rowwise_adagrad and adam equal the same engine's device path (the
  initial tables bit-equal, the outputs and tables within 1e-6 of each
  tensor's max: the same optimizer code, summed in the same order), and
  the JAX package's host engine from the same tables within 1e-5 (the
  tolerance of the JAX package's own host-versus-device test);
- other sparse optimizers, and two ranks, raise;
- a lookup of rows the train step gathered (``host_rows``) equals the
  lookup's own gather, bit for bit;
- the tables and row state round-trip through a checkpoint;
- ``train_and_evaluate`` of a DeepFM with a host-offloaded table equals
  the run with that table on the device from the same weights: the ZCH
  mappings exactly, the offloaded tables and their row state within 1e-5
  of each tensor's max (the bound of the JAX package's host-versus-device
  test), every other tensor within 1e-4 (the dense bound of
  test_torch_port_train.py);
- the planner of ``main.plan_tables`` keeps only the ZCH tables off the
  host tier;
- the export artifact of a DeepFM with ZCH, dynamicemb and a
  host-offloaded table predicts as ``predict_checkpoint`` does, bit for
  bit."""

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
    deepfm_cols,
    zch_deepfm_config_text,
)
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.utils import SparseField
from torcheasyrec_tpu_torch.parallel import emb_engine as pe
from torcheasyrec_tpu_torch.parallel.emb_engine import (
    HOST_OFFLOAD,
    EmbeddingEngine,
    TableSpec,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer

OPTS = [("adagrad", {"lr": 0.05}), ("sgd", {"lr": 0.05}),
        ("rowwise_adagrad", {"lr": 0.05}), ("adam", {"lr": 0.01})]


def _mk(sharding, m):
    """(tables, lookups) of the test's engine, built from module ``m``'s
    spec classes (the port's engine module or the JAX package's)."""
    tables = [m.TableSpec("t_a", rows=100, dim=16, sharding=sharding),
              m.TableSpec("t_b", rows=50, dim=8, sharding=sharding)]
    lookups = [m.LookupSpec("a", "f_a", "t_a", "sum"),
               m.LookupSpec("b", "f_b", "t_b", "mean"),
               m.LookupSpec("s", "f_s", "t_a", combiner="none",
                            is_sequence=True)]
    return tables, lookups


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 3, size=b).astype(np.int32)
    n = int(lengths.sum())
    vals = np.full(16, -1, np.int64)
    vals[:n] = rng.integers(0, 100, size=n)
    return {
        "sparse": {"f_a": (vals.astype(np.int32), lengths),
                   "f_b": (rng.integers(0, 50, size=(b, 2)).astype(np.int32),
                           None)},
        "seq": {"f_s": (rng.integers(-1, 100, size=(b, 4)).astype(np.int32),
                        rng.integers(0, 5, size=b).astype(np.int32))},
    }


def _port_fields(d):
    return {k: SparseField(torch.from_numpy(v), None if ln is None
                           else torch.from_numpy(ln))
            for k, (v, ln) in d.items()}


def _jax_fields(d):
    from torcheasyrec_tpu.datasets.utils import SparseField as JField

    return {k: JField(values=jnp.asarray(v), lengths=None if ln is None
                      else jnp.asarray(ln)) for k, (v, ln) in d.items()}


def _grads(outputs, step):
    return {k: np.random.default_rng(step * 10 + i).normal(
        size=tuple(v.shape)).astype(np.float32)
        for i, (k, v) in enumerate(sorted(outputs.items()))}


@pytest.mark.parametrize("opt_kind,cfg", OPTS, ids=[o for o, _ in OPTS])
def test_host_matches_device_path_and_jax(opt_kind, cfg):
    from torcheasyrec_tpu.parallel import emb_engine as je
    from torcheasyrec_tpu.parallel.sparse_optim import (
        SparseOptimizer as JOpt,
    )

    dev = EmbeddingEngine(*_mk("", pe), SparseOptimizer(opt_kind, cfg))
    host = EmbeddingEngine(*_mk(HOST_OFFLOAD, pe),
                           SparseOptimizer(opt_kind, cfg))
    assert host.has_host_groups and not dev.has_host_groups
    t_dev = dev.init_tables(torch.Generator().manual_seed(7))
    t_host = host.init_tables(torch.Generator().manual_seed(7))
    s_dev, s_host = dev.init_opt_state(), host.init_opt_state()
    jeng = je.EmbeddingEngine(*_mk(HOST_OFFLOAD, je),
                              optimizer=JOpt(opt_kind, cfg))
    jeng.init(jax.random.key(7))
    jeng.init_opt_state()
    for tn in ("t_a", "t_b"):
        # offloading a table changes no initial value
        assert torch.equal(dev.extract_table(t_dev, tn),
                           host.extract_table(t_host, tn))
        # the JAX engine starts from the port's tables
        jeng.extract_table({}, tn)[...] = dev.extract_table(
            t_dev, tn).numpy()
    for step in range(3):
        b = _batch(step)
        out_d, res_d = dev.lookup(t_dev, _port_fields(b["sparse"]),
                                  _port_fields(b["seq"]))
        out_h, res_h = host.lookup(t_host, _port_fields(b["sparse"]),
                                   _port_fields(b["seq"]))
        js, jq = _jax_fields(b["sparse"]), _jax_fields(b["seq"])
        rows, ids = jeng.host_prefetch(js, jq)
        out_j, res_j = jeng.lookup({}, js, jq, host_rows={
            gk: jnp.asarray(v) for gk, v in rows.items()})
        grads = _grads(out_d, step)
        for k in out_d:
            assert_close_to_max(out_h[k].numpy(), out_d[k].numpy(),
                                f"output {k}", 1e-6)
            assert_close_to_max(out_h[k].numpy(), np.asarray(out_j[k]),
                                f"output {k} (jax)", 1e-5)
        g = {k: torch.from_numpy(v) for k, v in grads.items()}
        dev.update(t_dev, s_dev, res_d, g, 1.0)
        host.update(t_host, s_host, res_h, g, 1.0)
        hg = jeng.host_row_grads(res_j, {k: jnp.asarray(v)
                                         for k, v in grads.items()})
        jeng.host_apply({gk: np.asarray(v) for gk, v in hg.items()}, ids,
                        1.0)
    for tn in ("t_a", "t_b"):
        got = host.extract_table(t_host, tn).numpy()
        assert_close_to_max(got, dev.extract_table(t_dev, tn).numpy(),
                            f"table {tn}", 1e-6)
        assert_close_to_max(got, jeng.extract_table({}, tn), f"{tn} (jax)",
                            1e-5)
        for k, v in jeng.extract_table_state({}, {}, tn).items():
            pst = host.extract_table_state(t_host, s_host, tn)[k]
            v = np.asarray(v)
            assert_close_to_max(pst.numpy().reshape(v.shape), v,
                                f"{tn}.{k} (jax)", 1e-5)
    assert all(t.device.type == "cpu" for t in t_host.values())


def test_host_rejects_unsupported_optimizer():
    with pytest.raises(ValueError, match="host_offload supports"):
        EmbeddingEngine(*_mk(HOST_OFFLOAD, pe),
                        SparseOptimizer("lamb", {"lr": 0.01}))


def test_host_offload_over_two_ranks_raises():
    from torcheasyrec_tpu_torch.parallel.mesh import ShardContext

    with pytest.raises(NotImplementedError, match="one rank"):
        EmbeddingEngine(*_mk(HOST_OFFLOAD, pe),
                        SparseOptimizer("adagrad", {"lr": 0.1}),
                        shard=ShardContext(0, 2, torch.device("cpu")))


def test_lookup_of_gathered_rows_equals_its_own_gather():
    eng = EmbeddingEngine(*_mk(HOST_OFFLOAD, pe),
                          SparseOptimizer("adagrad", {"lr": 0.5}))
    tables = eng.init_tables(torch.Generator().manual_seed(1))
    b = _batch(1)
    sp, sq = _port_fields(b["sparse"]), _port_fields(b["seq"])
    rows = eng.host_gather(tables, sp, sq)
    assert set(rows) == {gk for gk, g in eng.groups.items()
                         if g.sharding == HOST_OFFLOAD}
    out_a, res_a = eng.lookup(tables, sp, sq, host_rows=rows)
    out_b, res_b = eng.lookup(tables, sp, sq)
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    for gk in res_a:
        assert torch.equal(res_a[gk][2], res_b[gk][2]), gk


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host"))
    tbl = pa.table(deepfm_cols(768 + 256, 9))
    train, evalp = (os.path.join(root, f) for f in ("train.parquet",
                                                     "eval.parquet"))
    pq.write_table(tbl.slice(0, 768), train)
    pq.write_table(tbl.slice(768), evalp)
    return root, train, evalp


def _cfg(data, name, num_steps=10, host=True):
    """The ZCH DeepFM's config; without ``host`` its host-offloaded
    tables stay on the device."""
    root, train, evalp = data
    path = os.path.join(root, f"{name}.config")
    text = zch_deepfm_config_text(
        train, evalp, batch_size=64, num_steps=num_steps,
        model_dir=os.path.join(root, name))
    if not host:
        text = text.replace(
            ' embedding_constraints { sharding_types: "host_offload" }', "")
        assert "host_offload" not in text
    with open(path, "w") as f:
        f.write(text)
    return path


def test_train_and_evaluate_host_tables_match_the_device_run(data,
                                                            tmp_path):
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    host_cfg = _cfg(data, "on_host", num_steps=8)
    dev_cfg = _cfg(data, "on_device", num_steps=8, host=False)
    model, _ = port_main.build_model(
        config_util.load_pipeline_config(host_cfg), "cpu")
    init = str(tmp_path / "init.pt")
    torch.save(model.state_dict(), init)
    offloaded = {t for t, gk in model.embedding_group.engine._table_group
                 .items() if gk.endswith("_host_offload")}
    assert offloaded == {"cat_2_emb", "cat_2_emb__wide"}
    ckpts = []
    for cfg, name in ((host_cfg, "on_host"), (dev_cfg, "on_device")):
        port_main.train_and_evaluate(cfg, fine_tune_checkpoint=init,
                                     device="cpu")
        ckpts.append(torch.load(checkpoint_util.latest_checkpoint(
            os.path.join(data[0], name)), weights_only=True))
    a, b = ckpts
    assert a["step"] == b["step"] == 8
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        if not v.is_floating_point():
            assert torch.equal(v, b["model"][k]), k
            continue
        tol = 1e-5 if k.split(".")[-1] in offloaded else 1e-4
        assert_close_to_max(v.numpy(), b["model"][k].numpy(), k, tol)
    for t in offloaded:
        for k, v in a["sparse_opt"][t].items():
            assert_close_to_max(v.numpy(), b["sparse_opt"][t][k].numpy()
                                .reshape(v.shape), f"{t}.{k}", 1e-5)


def test_host_tables_round_trip_a_checkpoint(data):
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    cfg = _cfg(data, "ckpt", num_steps=4)
    port_main.train_and_evaluate(cfg, device="cpu")
    ckpt = checkpoint_util.latest_checkpoint(os.path.join(data[0], "ckpt"))
    pc = config_util.load_pipeline_config(cfg)
    model, _, _ = port_main._build_model_and_optim(pc, "cpu", seed=99)
    eg = model.embedding_group
    assert "d8_host_offload" in eg.engine.groups
    restored = checkpoint_util.restore_checkpoint(ckpt, model)
    saved = torch.load(ckpt, weights_only=True)
    for n in ("cat_2_emb", "cat_2_emb__wide"):
        assert torch.equal(eg.engine.extract_table(eg.engine_tables(), n),
                           saved["model"][f"embedding_group.tables.{n}"])
        st = eg.engine.extract_table_state(eg.engine_tables(),
                                           restored["sparse_opt"], n)
        for k, v in saved["sparse_opt"][n].items():
            assert torch.equal(st[k], v), (n, k)
    assert eg.engine_tables()["d8_host_offload"].device.type == "cpu"


def test_plan_tables_keeps_only_zch_tables_off_the_host(monkeypatch):
    from torcheasyrec_tpu_torch.parallel import planner
    from torcheasyrec_tpu_torch.parallel.mesh import ShardContext
    from torcheasyrec_tpu_torch.utils.config_util import (
        parse_pipeline_config,
    )

    seen = {}

    def fake_plan_cost(specs, **kw):
        seen.update(kw)
        return {}, 0.0, {}

    monkeypatch.setattr(planner, "plan_cost", fake_plan_cost)
    specs = [TableSpec("a", 10, 8), TableSpec("z", 10, 8)]
    port_main.plan_tables(specs, ShardContext(0, 2, torch.device("cpu")),
                          parse_pipeline_config(zch_deepfm_config_text()),
                          "adagrad", {"z"})
    assert seen["host_excluded"] == {"z"}


def test_export_artifact_predict_equals_predict_checkpoint(data, tmp_path):
    cfg = _cfg(data, "export", num_steps=6)
    port_main.train_and_evaluate(cfg, device="cpu")
    out = str(tmp_path / "export")
    port_main.export(cfg, out, device="cpu")
    prog = torch.export.load(os.path.join(out, port_main.PREDICT_PROGRAM))
    assert any(k.endswith("zch.cat_0_emb.keys") for k in prog.state_dict)
    evalp = data[2]
    port_main.predict_checkpoint(cfg, evalp, str(tmp_path / "ckpt.parquet"),
                                 device="cpu")
    port_main.predict(evalp, str(tmp_path / "art.parquet"), out,
                      device="cpu")
    a = pq.read_table(str(tmp_path / "ckpt.parquet"))
    b = pq.read_table(str(tmp_path / "art.parquet"))
    assert a.num_rows == 256
    for col in ("probs", "logits"):
        np.testing.assert_array_equal(a[col].to_numpy(), b[col].to_numpy())

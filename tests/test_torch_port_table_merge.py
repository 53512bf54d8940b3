"""The co-keyed table merge of the port's engine against the JAX
engine's (both merged, the JAX default; CPU).

The merge: the port fuses exactly the clusters the JAX
``merge_cokeyed_tables`` fuses, under the same names, column offsets and
lookups, for the JAX test's specs (``tests/test_table_merge.py``), the
uncapped Criteo DeepFM and criteo_synth configs; its group keys are the
JAX keys without the one-device layout name (``d20_data_parallel_s16.4``
is ``d20_s16.4``). One step of each of the ten sparse kinds in the
unpacked, packed and dense-lane layouts from the JAX engine's tables:
outputs within rtol 1e-6, tables and row state within rtol 1e-5 / atol
1e-7 (the JAX test's bounds; the packed delta merge adds about 1 ulp).
Jagged and sequence lookups and a BF16 merged table the same way. Tables
read by differing streams do not merge; ``tables_for_features`` gives
original names; a checkpoint restores exactly across the merge on and
off, both ways, and the initial values do not depend on the merge."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheasyrec_tpu.datasets.utils import SparseField as JaxField
from torcheasyrec_tpu.parallel import emb_engine as jax_engine
from torcheasyrec_tpu.parallel.sparse_optim import (
    SparseOptimizer as JaxSparseOptimizer,
)
from torcheasyrec_tpu_torch.datasets.utils import SparseField
from torcheasyrec_tpu_torch.parallel.emb_engine import (
    EmbeddingEngine,
    LookupSpec,
    TableSpec,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import (
    PORTED_KINDS,
    SparseOptimizer,
)

OUT_TOL = dict(rtol=1e-6, atol=0)
STATE_TOL = dict(rtol=1e-5, atol=1e-7)
CFGS = {
    "sgd": {"lr": 0.1},
    "adagrad": {"lr": 0.1, "initial_accumulator_value": 0.1},
    "rowwise_adagrad": {"lr": 0.1, "initial_accumulator_value": 0.05},
    "adam": {"lr": 0.01},
    "partial_rowwise_adam": {"lr": 0.01, "weight_decay": 0.01},
    "lamb": {"lr": 0.01},
    "partial_rowwise_lamb": {"lr": 0.01, "weight_decay": 0.01},
    "lars_sgd": {"lr": 0.5, "momentum": 0.8, "eta": 0.01},
    "adadelta": {"lr": 1.0, "rho": 0.9},
    "rmsprop": {"lr": 0.01, "alpha": 0.9, "weight_decay": 0.001},
}
# the JAX test's specs (t_wide and t_deep merge) and a co-keyed pair read
# by a jagged and a sequence stream (j_a and j_b merge)
TABLES = [("t_wide", 50, 4, "FP32"), ("t_deep", 50, 16, "FP32"),
          ("t_solo", 30, 16, "FP32")]
LOOKUPS = [("w:f", "f", "t_wide", "sum", False),
           ("d:f", "f", "t_deep", "sum", False),
           ("s:g", "g", "t_solo", "mean", False)]
JAGGED_TABLES = [("j_a", 40, 8, "FP32"), ("j_b", 40, 4, "FP32"),
                 ("h_a", 64, 8, "BF16"), ("h_b", 64, 8, "BF16")]
JAGGED_LOOKUPS = [("a:j", "j", "j_a", "mean", False),
                  ("b:j", "j", "j_b", "mean", False),
                  ("a:q", "q", "j_a", "none", True),
                  ("b:q", "q", "j_b", "none", True),
                  ("ha:f", "f", "h_a", "sum", False),
                  ("hb:f", "f", "h_b", "sum", False)]
LAYOUTS = {"unpacked": ("0", 0), "packed": ("1", 0), "dense_lane": ("1", 64)}
B = 8


def _engines(kind, layout, monkeypatch, tables=TABLES, lookups=LOOKUPS):
    packed, lane = LAYOUTS[layout]
    monkeypatch.setenv("TZREC_PACKED", packed)
    monkeypatch.setenv("TZREC_DENSE_LANE", str(lane))
    monkeypatch.delenv("TZREC_TABLE_MERGE", raising=False)
    jeng = jax_engine.EmbeddingEngine(
        [jax_engine.TableSpec(n, r, d, sharding="row_wise", dtype=t)
         for n, r, d, t in tables],
        [jax_engine.LookupSpec(k, f, n, c, q) for k, f, n, c, q in lookups],
        optimizer=JaxSparseOptimizer(kind, CFGS[kind]))
    peng = EmbeddingEngine(
        [TableSpec(n, r, d, dtype=t) for n, r, d, t in tables],
        [LookupSpec(k, f, n, c, q) for k, f, n, c, q in lookups],
        SparseOptimizer(kind, CFGS[kind]), packed=packed == "1",
        dense_lane_rows=lane)
    return jeng, peng


def _jax_key(gk: str) -> str:
    return gk.replace("_data_parallel", "")


def _jax_tables(jeng, seed):
    """Seeded storage for the JAX engine (its ``init`` compiles a chunked
    generator per group, slow on the CPU)."""
    r = np.random.default_rng(seed)
    fills = jeng.optimizer.row_state_init()
    out = {}
    for gk, g in jeng.groups.items():
        w = ((r.random((g.padded_rows, g.dim), np.float32) - 0.5) * 0.2)
        if not g.packed:
            out[gk] = jnp.asarray(w).astype(g.store_dtype)
            continue
        srows = {n: np.full((g.padded_rows, width), fills.get(n, 0.0),
                            np.float32) for n, width in g.state_widths}
        out[gk] = jeng.pack_group(g, w, srows)
    return out


def _carry(jeng, jtables, peng, names):
    ptables = peng.init_tables(torch.Generator().manual_seed(0))
    pstate = peng.init_opt_state()
    jstate = jeng.init_opt_state()
    for name in names:
        peng.write_table(ptables, name, torch.from_numpy(
            np.array(jeng.extract_table(jtables, name), np.float32)))
        peng.write_table_state(ptables, pstate, name, {
            k: torch.from_numpy(np.array(v)) for k, v in
            jeng.extract_table_state(jtables, jstate, name).items()})
    return ptables, pstate, jstate


def _fields(seed):
    r = np.random.default_rng(seed)
    f = r.integers(0, 50, (B, 2))
    f[1] = f[0]
    f[r.random((B, 2)) < 0.2] = -1
    g = r.integers(0, 30, (B, 1))
    lengths = r.integers(0, 4, B).astype(np.int32)
    j = np.full(32, -1, np.int64)
    j[:lengths.sum()] = r.integers(0, 40, lengths.sum())
    q = r.integers(0, 40, (B, 3))
    q[:, 2] = -1
    q_len = np.full(B, 2, np.int32)
    return ({"f": (f, None), "g": (g, None), "j": (j, lengths)},
            {"q": (q, q_len)})


def _as(fields, cls, conv):
    return {k: cls(conv(v.astype(np.int32)),
                   lengths=None if n is None else conv(n))
            for k, (v, n) in fields.items()}


def _step_both(jeng, peng, names, seed=0):
    """One lookup and update in both engines from the same tables and
    output gradients: (JAX outputs, port outputs, JAX tables and state,
    port tables and state)."""
    jtables = _jax_tables(jeng, seed)
    ptables, pstate, jstate = _carry(jeng, jtables, peng, names)
    sp, sq = _fields(seed + 1)
    pout, pres = peng.lookup(ptables, _as(sp, SparseField, torch.from_numpy),
                             _as(sq, SparseField, torch.from_numpy))
    r = np.random.default_rng(seed + 2)
    grads = {k: r.normal(size=v.shape).astype(np.float32)
             for k, v in pout.items()}

    @jax.jit
    def jstep(tables, state, fields, seq, g):
        out, res = jeng.lookup(tables, fields, seq)
        tables, state = jeng.update(tables, state, res, g, jnp.float32(0.5))
        return out, tables, state

    jout, jtables, jstate = jstep(
        jtables, jstate, _as(sp, JaxField, jnp.asarray),
        _as(sq, JaxField, jnp.asarray),
        {k: jnp.asarray(v).astype(pout[k].dtype == torch.bfloat16
                                  and jnp.bfloat16 or jnp.float32)
         for k, v in grads.items()})
    peng.update(ptables, pstate, pres,
                {k: torch.from_numpy(v).to(pout[k].dtype)
                 for k, v in grads.items()}, 0.5)
    return jout, pout, (jtables, jstate), (ptables, pstate)


def _assert_tables(jeng, peng, jts, pts, names):
    for name in names:
        np.testing.assert_allclose(
            peng.extract_table(pts[0], name).float().numpy(),
            np.asarray(jeng.extract_table(jts[0], name), np.float32),
            err_msg=name, **STATE_TOL)
        jst = jeng.extract_table_state(jts[0], jts[1], name)
        pst = peng.extract_table_state(pts[0], pts[1], name)
        assert set(jst) == set(pst), name
        for k in jst:
            np.testing.assert_allclose(
                pst[k].float().numpy().reshape(np.shape(jst[k])),
                np.asarray(jst[k], np.float32), err_msg=f"{name}.{k}",
                **STATE_TOL)


def test_merge_map_and_groups_match_jax(monkeypatch):
    jeng, peng = _engines("rowwise_adagrad", "packed", monkeypatch)
    assert peng._merged == jeng._merged == {
        "t_deep": ("__merged__t_deep+t_wide", 0, 16),
        "t_wide": ("__merged__t_deep+t_wide", 16, 4)}
    assert set(peng.groups) == {_jax_key(k) for k in jeng.groups}
    assert "d20_s16.4" in peng.groups
    for gk, g in peng.groups.items():
        jg = jeng.groups[next(k for k in jeng.groups if _jax_key(k) == gk)]
        assert g.col_segments == jg.col_segments
        assert (g.packed, g.slot, g.spr, g.p_rows) == (
            jg.packed, jg.slot, jg.spr, jg.p_rows)
        assert [t.name for t in g.specs] == [t.name for t in jg.specs]
    g = peng.groups["d20_s16.4"]
    assert (g.slot, g.spr) == (22, 5)  # 20 weights, 2 accumulators
    plk = [lk for lks in peng._lookups_by_group.values() for lk in lks]
    jlk = [lk for lks in jeng._lookups_by_group.values() for lk in lks]
    assert sorted((lk.key, lk.table_name, lk.col_outputs) for lk in plk) == (
        sorted((lk.key, lk.table_name, lk.col_outputs) for lk in jlk))
    monkeypatch.setenv("TZREC_TABLE_MERGE", "0")
    off = EmbeddingEngine([TableSpec(n, r, d) for n, r, d, _ in TABLES],
                          [LookupSpec(*x) for x in LOOKUPS])
    assert off._merged == {} and "d20_s16.4" not in off.groups


def _config_groups(text):
    """(port engine, JAX engine) of one config text, built without
    tables (each package's model factory, as its ``main`` calls it)."""
    from google.protobuf import text_format

    from torcheasyrec_tpu.features import create_features as jax_features
    from torcheasyrec_tpu.models import create_model as jax_model
    from torcheasyrec_tpu.optim.optimizer_builder import (
        create_sparse_optimizer as jax_sparse_optimizer,
    )
    from torcheasyrec_tpu.protos import pipeline_pb2
    from torcheasyrec_tpu_torch.features.feature import create_features
    from torcheasyrec_tpu_torch.models import create_model
    from torcheasyrec_tpu_torch.optim.optimizer_builder import (
        create_sparse_optimizer,
    )
    from torcheasyrec_tpu_torch.utils.config_util import (
        parse_pipeline_config,
    )

    jcfg = text_format.Parse(text, pipeline_pb2.EasyRecConfig())
    jmodel = jax_model(
        jcfg.model_config, jax_features(
            list(jcfg.feature_configs), fg_mode=jcfg.data_config.fg_mode),
        list(jcfg.data_config.label_fields), [],
        sparse_optimizer=jax_sparse_optimizer(
            jcfg.train_config.sparse_optimizer)[0])
    cfg = parse_pipeline_config(text)
    model = create_model(
        cfg.model_config, create_features(
            list(cfg.feature_configs), fg_mode=cfg.data_config.fg_mode),
        list(cfg.data_config.label_fields), [],
        generator=torch.Generator(), sparse_optimizer=create_sparse_optimizer(
            cfg.train_config.sparse_optimizer)[0], build_tables=False)
    return model.embedding_group.engine, jmodel.embedding_group.engine


def _criteo_synth_text(name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "torcheasyrec_tpu_torch", "benchmark",
        "configs", "criteo_synth", f"{name}.config")
    with open(path) as f:
        return f.read()


def _uncapped_deepfm_text():
    import chip_smoke

    return chip_smoke.deepfm_config_text(chip_smoke.CRITEO_RAW)


@pytest.mark.parametrize("which", ["uncapped_deepfm", "deepfm",
                                   "wide_and_deep", "dbmtl"])
def test_config_merges_match_jax(which, monkeypatch):
    monkeypatch.delenv("TZREC_TABLE_MERGE", raising=False)
    text = (_uncapped_deepfm_text() if which == "uncapped_deepfm"
            else _criteo_synth_text(which))
    peng, jeng = _config_groups(text)
    assert peng._merged == jeng._merged
    assert set(peng.groups) == {_jax_key(k) for k in jeng.groups}
    for gk, g in peng.groups.items():
        jg = jeng.groups[next(k for k in jeng.groups if _jax_key(k) == gk)]
        assert (g.col_segments, g.packed, g.slot, g.spr) == (
            jg.col_segments, jg.packed, jg.slot, jg.spr), gk
    if which == "uncapped_deepfm":
        # 26 (dim 16 DEEP + dim 4 WIDE) pairs: one group of 22-lane slots
        assert len(peng._merged) == 52
        g = peng.groups["d20_s16.4"]
        assert len(g.specs) == 26 and (g.slot, g.spr) == (22, 5)
        assert sum(t.rows for t in g.specs) == 204_184_588


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_merged_step_matches_jax(kind, layout, monkeypatch):
    jeng, peng = _engines(kind, layout, monkeypatch)
    assert peng._merged and jeng._merged
    names = [n for n, _, _, _ in TABLES]
    jout, pout, jts, pts = _step_both(jeng, peng, names)
    assert set(jout) == set(pout) == {"w:f", "d:f", "s:g"}
    for k in jout:
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **OUT_TOL)
    _assert_tables(jeng, peng, jts, pts, names)


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_merged_jagged_sequence_and_bf16_match_jax(layout, monkeypatch):
    jeng, peng = _engines("rowwise_adagrad", layout, monkeypatch,
                          JAGGED_TABLES, JAGGED_LOOKUPS)
    assert set(peng._merged) == set(jeng._merged) == {
        "j_a", "j_b", "h_a", "h_b"}
    assert "d16_bf16_s8.8" in peng.groups
    names = [n for n, _, _, _ in JAGGED_TABLES]
    jout, pout, jts, pts = _step_both(jeng, peng, names)
    assert set(jout) == set(pout)
    for k in jout:
        assert pout[k].dtype == (torch.bfloat16 if k.startswith("h")
                                 else torch.float32), k
        np.testing.assert_allclose(
            pout[k].float().numpy(), np.asarray(jout[k], np.float32),
            err_msg=k, **OUT_TOL)
    _assert_tables(jeng, peng, jts, pts, names)


def test_differing_streams_do_not_merge():
    tables = [TableSpec("a", 50, 4), TableSpec("b", 50, 8),
              TableSpec("c", 40, 4), TableSpec("z", 50, 4),
              TableSpec("z__wide", 50, 8), TableSpec("cw1", 50, 4,
                                                     sharding="column_wise")]
    lookups = [LookupSpec("a:f", "f", "a"), LookupSpec("b:g", "g", "b"),
               LookupSpec("c:f", "f", "c"), LookupSpec("z:h", "h", "z"),
               LookupSpec("zw:h", "h", "z__wide"),
               LookupSpec("a:x", "x", "a"), LookupSpec("cw:x", "x", "cw1")]
    eng = EmbeddingEngine(tables, lookups, SparseOptimizer("adagrad", {}),
                          no_merge_tables={"z"}, merge=True)
    # a and c: other rows; a and b: other features; z and its suffixed
    # twin: excluded by name
    assert eng._merged == {}
    jeng = jax_engine.EmbeddingEngine(
        [jax_engine.TableSpec(t.name, t.rows, t.dim) for t in tables],
        [jax_engine.LookupSpec(lk.key, lk.feature_name, lk.table_name)
         for lk in lookups], no_merge_tables={"z"})
    assert jeng._merged == {}


def test_tables_for_features_returns_original_names(monkeypatch):
    _, peng = _engines("adagrad", "unpacked", monkeypatch)
    assert peng.tables_for_features({"f"}) == {"t_wide", "t_deep"}
    assert peng.tables_for_features({"g"}) == {"t_solo"}
    assert peng.table_columns("t_wide") == (16, 4)


@pytest.mark.parametrize("src_merge,dst_merge,dst_packed", [
    (True, False, False), (False, True, True), (True, True, False),
    (True, False, True)])
def test_checkpoint_restores_across_the_merge(src_merge, dst_merge,
                                              dst_packed):
    """A merged engine's per-table state restores exactly into an
    unmerged one and back (``extract_table[_state]`` / ``write_table
    [_state]``, what the checkpoint stores), and both draw the same
    initial values."""
    opt = SparseOptimizer("partial_rowwise_adam", CFGS["partial_rowwise_adam"])
    tabs = [TableSpec(n, r, d) for n, r, d, _ in TABLES]
    lks = [LookupSpec(*x) for x in LOOKUPS]
    names = [t.name for t in tabs]
    src = EmbeddingEngine(tabs, lks, opt, packed=False, merge=src_merge)
    dst = EmbeddingEngine(tabs, lks, opt, packed=dst_packed, merge=dst_merge)
    assert bool(src._merged) == src_merge and bool(dst._merged) == dst_merge
    st, ss = src.init_tables(torch.Generator().manual_seed(4)), \
        src.init_opt_state()
    dt, ds = dst.init_tables(torch.Generator().manual_seed(4)), \
        dst.init_opt_state()
    for n in names:
        assert torch.equal(src.extract_table(st, n), dst.extract_table(dt, n))
    sp, sq = _fields(7)
    out, res = src.lookup(st, _as(sp, SparseField, torch.from_numpy))
    src.update(st, ss, res, {k: torch.ones_like(v) * 0.1
                             for k, v in out.items()}, 1.0)
    dt, ds = dst.init_tables(torch.Generator().manual_seed(99)), \
        dst.init_opt_state()
    for n in names:
        dst.write_table(dt, n, src.extract_table(st, n))
        dst.write_table_state(dt, ds, n, src.extract_table_state(st, ss, n))
    for n in names:
        assert torch.equal(dst.extract_table(dt, n), src.extract_table(st, n))
        a = dst.extract_table_state(dt, ds, n)
        b = src.extract_table_state(st, ss, n)
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k].reshape(b[k].shape), b[k]), (n, k)
        assert a["v"].shape == (src._specs[n].rows, 1)

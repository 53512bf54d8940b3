"""The packed 128-lane embedding engine of the port against the JAX
engine (fp32, CPU; the JAX engine packs by default and writes rows
through its XLA scatter here).

Layout: the same specs give the same slot widths, rows per physical
row, table offsets, padded and physical row counts and dense-lane
region; pack/unpack round-trips. Lookup: equal values (``==``: the JAX
one-hot sum turns -0.0 into +0.0, so not bit-equal). Update: 3 steps
with sgd, adagrad, rowwise_adagrad and adam, the dense lane on and off,
tables and row state through ``extract_table[_state]`` at rtol 1e-6 /
atol 1e-7 (the same formulas in another library's fp32 arithmetic, sums
of duplicates in another order). The JAX engine's co-keyed table merge
is switched off so that both sides hold the same groups."""

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
from torcheasyrec_tpu_torch.ops.row_write import write_rows
from torcheasyrec_tpu_torch.parallel.emb_engine import (
    EmbeddingEngine,
    LookupSpec,
    TableSpec,
    _slots,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import (
    PORTED_KINDS,
    SparseOptimizer,
)

TOL = dict(rtol=1e-6, atol=1e-7)
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
# (name, rows, dim): two dims, tables on both sides of the dense-lane line
TABLES = [("big_a", 700, 8), ("small_a", 23, 8), ("big_b", 301, 8),
          ("small_b", 5, 8), ("wide_a", 700, 4), ("wide_s", 23, 4)]
LOOKUPS = [("big_a", "f_a", "sum"), ("small_a", "f_s", "sum"),
           ("big_b", "f_j", "mean"), ("small_b", "f_t", "sum"),
           ("wide_a", "f_a", "sum"), ("wide_s", "f_s", "sum")]
DENSE_LANE = 64  # small_a, small_b and wide_s take the dense lane
B = 16


def _engines(kind, dense_lane, monkeypatch):
    monkeypatch.setenv("TZREC_TABLE_MERGE", "0")
    monkeypatch.setenv("TZREC_DENSE_LANE", str(dense_lane))
    monkeypatch.setenv("TZREC_PACKED", "1")
    jeng = jax_engine.EmbeddingEngine(
        [jax_engine.TableSpec(n, r, d, sharding="data_parallel")
         for n, r, d in TABLES],
        [jax_engine.LookupSpec(f"{t}:{f}", f, t, c) for t, f, c in LOOKUPS],
        optimizer=JaxSparseOptimizer(kind, CFGS[kind]))
    peng = EmbeddingEngine(
        [TableSpec(n, r, d) for n, r, d in TABLES],
        [LookupSpec(f"{t}:{f}", f, t, c) for t, f, c in LOOKUPS],
        SparseOptimizer(kind, CFGS[kind]), packed=True,
        dense_lane_rows=dense_lane)
    return jeng, peng


def _by_dim(jeng):
    return {f"d{g.dim}": g for g in jeng.groups.values()}


def _batch(seed):
    """numpy id fields: fixed single- and multi-valued with padding and
    duplicates, and one jagged field."""
    r = np.random.default_rng(seed)
    f_a = r.integers(0, 700, (B, 3))
    f_a[r.random((B, 3)) < 0.2] = -1
    f_a[1] = f_a[0]  # duplicates across samples
    f_s = r.integers(0, 23, (B, 1))
    f_t = r.integers(0, 5, (B, 2))
    lengths = r.integers(0, 4, B).astype(np.int32)
    n_pad = 48
    f_j = np.full(n_pad, -1, np.int64)
    f_j[:lengths.sum()] = r.integers(0, 301, lengths.sum())
    return {"f_a": (f_a, None), "f_s": (f_s, None), "f_t": (f_t, None),
            "f_j": (f_j, lengths)}


def _fields(batch, field_cls, conv):
    return {k: field_cls(conv(v.astype(np.int32)),
                         lengths=None if l is None else conv(l))
            for k, (v, l) in batch.items()}


def _jax_tables(jeng, seed):
    """Seeded tables for the JAX engine, packed on the host (its own
    ``init`` compiles a chunked generator per group, slow on the CPU)."""
    r = np.random.default_rng(seed)
    fills = jeng.optimizer.row_state_init()
    out = {}
    for gk, g in jeng.groups.items():
        w = (r.random((g.padded_rows, g.dim), np.float32) - 0.5) * 0.2
        srows = {n: np.full((g.padded_rows, width), fills.get(n, 0.0),
                            np.float32) for n, width in g.state_widths}
        out[gk] = jeng.pack_group(g, w, srows)
    return out


def _carry_tables(jeng, jtables, peng):
    """The port's storage holding the JAX engine's tables and state."""
    ptables = peng.init_tables(torch.Generator().manual_seed(0))
    pstate = peng.init_opt_state()
    jstate = jeng.init_opt_state()
    for name, _, _ in TABLES:
        peng.write_table(ptables, name, torch.from_numpy(
            np.array(jeng.extract_table(jtables, name))))
        peng.write_table_state(ptables, pstate, name, {
            k: torch.from_numpy(np.array(v)) for k, v in
            jeng.extract_table_state(jtables, jstate, name).items()})
    return ptables, pstate, jstate


@pytest.mark.parametrize("dense_lane", [0, DENSE_LANE])
@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_packed_layout_matches_jax(kind, dense_lane, monkeypatch):
    jeng, peng = _engines(kind, dense_lane, monkeypatch)
    jgroups = _by_dim(jeng)
    assert set(jgroups) == set(peng.groups)
    for gk, pg in peng.groups.items():
        jg = jgroups[gk]
        assert pg.packed and jg.packed
        assert (pg.slot, pg.spr, pg.p_rows, pg.total_rows) == (
            jg.slot, jg.spr, jg.p_rows, jg.padded_rows)
        assert tuple(pg.state_widths) == tuple(jg.state_widths)
        assert pg.offsets == jg.offsets
        assert pg.dense_rows == jg.dense_rows
        assert pg.dense_tables == jg.dense_tables
        assert [t.name for t in pg.specs] == [t.name for t in jg.specs]
        assert all(off % pg.spr == 0 for off in pg.offsets.values())
    if dense_lane and kind in EmbeddingEngine._DENSE_LANE_OPTS:
        assert peng.groups["d8"].dense_tables == {"small_a", "small_b"}
        assert peng.groups["d8"].offsets["small_a"] == 0
    else:
        assert not peng.groups["d8"].dense_rows


def test_wide_slot_over_128_lanes_does_not_pack():
    eng = EmbeddingEngine([TableSpec("t", 10, 64)], [],
                          SparseOptimizer("adam", CFGS["adam"]))
    assert not eng.groups["d64"].packed  # slot 192
    eng = EmbeddingEngine([TableSpec("t", 10, 64)], [],
                          SparseOptimizer("adagrad", CFGS["adagrad"]))
    assert eng.groups["d64"].packed and eng.groups["d64"].spr == 1
    eng = EmbeddingEngine([TableSpec("t", 10, 8)], [],
                          SparseOptimizer("sgd", CFGS["sgd"]), packed=False)
    assert not eng.groups["d8"].packed


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_pack_unpack_round_trip_and_jax_pack(kind, monkeypatch):
    jeng, peng = _engines(kind, 0, monkeypatch)
    r = np.random.default_rng(3)
    for gk, pg in peng.groups.items():
        jg = _by_dim(jeng)[gk]
        w = r.normal(size=(pg.total_rows, pg.dim)).astype(np.float32)
        srows = {n: r.random((pg.total_rows, width)).astype(np.float32)
                 for n, width in pg.state_widths}
        packed = peng.pack_group(pg, torch.from_numpy(w), {
            n: torch.from_numpy(v) for n, v in srows.items()})
        assert packed.shape == (pg.p_rows, 128)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jeng.pack_group(jg, w, srows)))
        w2, s2 = peng.unpack_group(pg, packed)
        assert torch.equal(w2, torch.from_numpy(w))
        for n in srows:
            assert torch.equal(s2[n], torch.from_numpy(srows[n]))
        # logical row r sits at physical row r // spr, slot r % spr
        row = pg.total_rows - 1
        assert torch.equal(
            _slots(packed, pg)[row // pg.spr, row % pg.spr, :pg.dim],
            torch.from_numpy(w[row]))


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "adam"])
def test_packed_init_fills_slots_and_state_lanes(kind, monkeypatch):
    _, peng = _engines(kind, DENSE_LANE, monkeypatch)
    tables = peng.init_tables(torch.Generator().manual_seed(5))
    state = peng.init_opt_state()
    fill = CFGS[kind].get("initial_accumulator_value", 0.0)
    for name, rows, dim in TABLES:
        w = peng.extract_table(tables, name)
        assert w.shape == (rows, dim)
        bound = 1.0 / rows ** 0.5
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.8 * bound and abs(float(w.mean())) < (
            bound / 2)
        st = peng.extract_table_state(tables, state, name)
        for k, v in st.items():
            if v.dim() >= 1:
                assert v.shape[0] == rows and (v == fill).all(), k
    for gk, g in peng.groups.items():
        assert tables[gk].shape == (g.p_rows, 128)
        # only scalars stay outside the rows
        assert all(v.dim() == 0 for v in state[gk].values())
        # lanes past the last slot stay zero
        assert (tables[gk][:, g.spr * g.slot:] == 0).all()


@pytest.mark.parametrize("dense_lane", [0, DENSE_LANE])
def test_packed_lookup_equals_jax(dense_lane, monkeypatch):
    jeng, peng = _engines("rowwise_adagrad", dense_lane, monkeypatch)
    jtables = _jax_tables(jeng, 0)
    ptables, _, _ = _carry_tables(jeng, jtables, peng)
    batch = _batch(0)
    jout, _ = jax.jit(lambda t, f: jeng.lookup(t, f)[0])(
        jtables, _fields(batch, JaxField, jnp.asarray)), None
    pout, res = peng.lookup(ptables, _fields(batch, SparseField,
                                             torch.from_numpy))
    assert set(jout) == set(pout)
    for k in jout:
        ref = np.asarray(jout[k])
        if k == "big_b:f_j":  # mean pooling divides: one rounding apart
            np.testing.assert_allclose(pout[k].numpy(), ref, rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        else:
            assert (pout[k].numpy() == ref).all(), k


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_f10_jagged_pooling_is_a_segment_sum_that_ignores_padding(
        combiner):
    """A jagged field's pooling equals ``index_add_`` over the segment
    ids bit for bit, and reads none of the padding rows after the last
    segment (here filled with values that would show)."""
    peng = EmbeddingEngine([TableSpec("big_b", 301, 8)],
                           [LookupSpec("big_b:f_j", "f_j", "big_b", combiner)],
                           SparseOptimizer("sgd", CFGS["sgd"]), packed=True)
    tables = peng.init_tables(torch.Generator().manual_seed(0))
    batch = {"f_j": _batch(3)["f_j"]}
    out, res = peng.lookup(tables, _fields(batch, SparseField,
                                           torch.from_numpy))
    (gk, (flat_ids, plan)), = res.items()
    g = peng.groups[gk]
    rows = peng._gather(g, tables[gk], flat_ids)
    e, = plan
    b = e.lengths.shape[0]
    n_real = int(e.lengths.sum())
    assert n_real < rows.shape[0]  # the field has padding slots
    ref = rows.new_zeros(b + 1, g.dim).index_add_(0, e.seg, rows)[:b]
    if combiner == "mean":
        ref = ref / e.lengths.float().clamp(min=1.0)[:, None]
    assert torch.equal(out["big_b:f_j"], ref)
    noisy = rows.clone()
    noisy[n_real:] = 1e30
    again = {}
    peng._emit_outputs(g, plan, noisy, again)
    assert torch.equal(again["big_b:f_j"], ref)


@pytest.mark.parametrize("dense_lane", [0, DENSE_LANE])
@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_packed_update_matches_jax_over_3_steps(kind, dense_lane,
                                                monkeypatch):
    jeng, peng = _engines(kind, dense_lane, monkeypatch)
    jtables = _jax_tables(jeng, 1)
    ptables, pstate, jstate = _carry_tables(jeng, jtables, peng)
    untouched = {n: np.array(jeng.extract_table(jtables, n))
                 for n, _, _ in TABLES}
    seen = {n: set() for n, _, _ in TABLES}
    launches = write_rows.launches
    r = np.random.default_rng(11)

    @jax.jit
    def jax_step(tables, state, fields, grads):
        _, res = jeng.lookup(tables, fields)
        return jeng.update(tables, state, res, grads, jnp.float32(0.5))

    for step in range(3):
        batch = _batch(100 + step)
        pout, pres = peng.lookup(ptables, _fields(batch, SparseField,
                                                  torch.from_numpy))
        grads = {k: r.normal(size=v.shape).astype(np.float32)
                 for k, v in pout.items()}
        jtables, jstate = jax_step(
            jtables, jstate, _fields(batch, JaxField, jnp.asarray),
            {k: jnp.asarray(v) for k, v in grads.items()})
        peng.update(ptables, pstate, pres,
                    {k: torch.from_numpy(v) for k, v in grads.items()}, 0.5)
        for t, f, _ in LOOKUPS:
            v = batch[f][0]
            seen[t].update(int(i) for i in v.reshape(-1) if i >= 0)
    for name, rows, _ in TABLES:
        np.testing.assert_allclose(
            peng.extract_table(ptables, name).numpy(),
            np.asarray(jeng.extract_table(jtables, name)), err_msg=name,
            **TOL)
        jst = jeng.extract_table_state(jtables, jstate, name)
        pst = peng.extract_table_state(ptables, pstate, name)
        assert set(jst) == set(pst)
        for k in jst:
            np.testing.assert_allclose(
                pst[k].numpy().reshape(np.shape(jst[k])), np.asarray(jst[k]),
                err_msg=f"{name}.{k}", **TOL)
        if kind != "adam":  # adam's decay moves nothing untouched either,
            # but its dense-lane gate is what this holds: rows the
            # batches never touched keep their bits
            rest = sorted(set(range(rows)) - seen[name])
            np.testing.assert_array_equal(
                peng.extract_table(ptables, name).numpy()[rest],
                untouched[name][rest])
    assert write_rows.launches == launches  # CPU tensors: plain version


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_packed_update_is_within_rounding_of_the_unpacked_one(kind):
    """3 steps packed (dense lane on) and unpacked from the same tables
    and gradients agree per table within 1e-5 relative."""
    tabs = [TableSpec(n, r, d) for n, r, d in TABLES]
    lks = [LookupSpec(f"{t}:{f}", f, t, c) for t, f, c in LOOKUPS]
    opt = SparseOptimizer(kind, CFGS[kind])
    ep = EmbeddingEngine(tabs, lks, opt, packed=True,
                         dense_lane_rows=DENSE_LANE)
    eu = EmbeddingEngine(tabs, lks, opt, packed=False)
    g = torch.Generator().manual_seed(2)
    tp, tu = ep.init_tables(g), eu.init_tables(g)
    for t in tabs:
        eu.write_table(tu, t.name, ep.extract_table(tp, t.name))
    sp, su = ep.init_opt_state(), eu.init_opt_state()
    for step in range(3):
        fields = _fields(_batch(step), SparseField, torch.from_numpy)
        op, rp = ep.lookup(tp, fields)
        ou, ru = eu.lookup(tu, fields)
        grads = {}
        for k in op:
            assert torch.equal(op[k], ou[k]), k
            grads[k] = torch.randn(op[k].shape, generator=g)
        ep.update(tp, sp, rp, grads, 1.0)
        eu.update(tu, su, ru, grads, 1.0)
    for t in tabs:
        np.testing.assert_allclose(ep.extract_table(tp, t.name).numpy(),
                                   eu.extract_table(tu, t.name).numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=t.name)
        sa = ep.extract_table_state(tp, sp, t.name)
        sb = eu.extract_table_state(tu, su, t.name)
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_allclose(
                sa[k].numpy(), sb[k].numpy(), rtol=1e-5, atol=1e-7,
                err_msg=f"{t.name}.{k}")


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad"])
def test_extract_from_a_packed_group_never_aliases_its_storage(kind):
    """A table shorter than one physical row, or a slot as wide as the
    table's dim, could come out as a view; a view saved with
    ``torch.save`` would write the group's whole storage."""
    tabs = [TableSpec("tiny", 3, 8), TableSpec("even", 28, 8),
            TableSpec("odd", 30, 8)]
    eng = EmbeddingEngine(tabs, [], SparseOptimizer(kind, CFGS[kind]))
    tables = eng.init_tables(torch.Generator().manual_seed(1))
    state = eng.init_opt_state()
    store = tables["d8"]
    for t in tabs:
        got = [eng.extract_table(tables, t.name)] + [
            v for v in eng.extract_table_state(tables, state,
                                               t.name).values()]
        for x in got:
            assert x.shape[0] == t.rows and x.is_contiguous()
            assert (x.untyped_storage().data_ptr()
                    != store.untyped_storage().data_ptr())
            assert x.untyped_storage().nbytes() == x.numel() * 4


def test_table_and_state_round_trip_between_layouts():
    """write_table / write_table_state are the inverses of
    extract_table / extract_table_state under both layouts, so state
    crosses from a packed engine to an unpacked one and back unchanged."""
    tabs = [TableSpec(n, r, d) for n, r, d in TABLES]
    opt = SparseOptimizer("adam", CFGS["adam"])
    ep = EmbeddingEngine(tabs, [], opt, packed=True)
    eu = EmbeddingEngine(tabs, [], opt, packed=False)
    g = torch.Generator().manual_seed(9)
    tp, tu = ep.init_tables(g), eu.init_tables(g)
    sp, su = ep.init_opt_state(), eu.init_opt_state()
    want = {}
    for t in tabs:
        w = torch.randn(t.rows, t.dim, generator=g)
        st = {"m": torch.randn(t.rows, t.dim, generator=g),
              "v": torch.rand(t.rows, t.dim, generator=g),
              "step": torch.tensor(4, dtype=torch.int32)}
        want[t.name] = (w, st)
        ep.write_table(tp, t.name, w)
        ep.write_table_state(tp, sp, t.name, st)
    for src_e, src_t, src_s, dst_e, dst_t, dst_s in (
            (ep, tp, sp, eu, tu, su), (eu, tu, su, ep, tp, sp)):
        for t in tabs:
            dst_e.write_table(dst_t, t.name,
                              src_e.extract_table(src_t, t.name))
            dst_e.write_table_state(
                dst_t, dst_s, t.name,
                src_e.extract_table_state(src_t, src_s, t.name))
    for e, tb, s in ((ep, tp, sp), (eu, tu, su)):
        for t in tabs:
            w, st = want[t.name]
            assert torch.equal(e.extract_table(tb, t.name), w)
            got = e.extract_table_state(tb, s, t.name)
            assert set(got) == set(st)
            for k in st:
                assert torch.equal(got[k], st[k]), k

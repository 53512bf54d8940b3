"""Sparse optimizers and the embedding engine's update of the port
against the JAX package (fp32, CPU).

``apply_rows`` and ``apply`` of each ported kind follow the JAX
``SparseOptimizer`` over 3 steps at rtol 1e-5 / atol 1e-7 (the same
formulas in another library's fp32 arithmetic); the engine's dedup
handles duplicate ids, -1 ids and an empty batch, and leaves untouched
rows bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

TOL = dict(rtol=1e-5, atol=1e-7)
ROWS, DIM = 40, 8
CFGS = {
    "sgd": {"lr": 0.1},
    "adagrad": {"lr": 0.1, "initial_accumulator_value": 0.1},
    "rowwise_adagrad": {"lr": 0.1, "eps": 1e-8},
    "adam": {"lr": 0.01, "weight_decay": 0.01},
}


def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_state_layout_matches_jax(kind):
    jopt, popt = JaxSparseOptimizer(kind, CFGS[kind]), SparseOptimizer(
        kind, CFGS[kind])
    assert popt.base_lr == jopt.base_lr
    assert popt.row_state_widths(DIM) == jopt.row_state_widths(DIM)
    assert popt.row_state_init() == jopt.row_state_init()
    jst, pst = jopt.init_state(ROWS, DIM), popt.init_state(ROWS, DIM)
    assert set(jst) == set(pst)
    for k in jst:
        np.testing.assert_array_equal(np.asarray(jst[k]), pst[k].numpy())


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_apply_rows_matches_jax_over_3_steps(kind):
    r = np.random.default_rng(0)
    jopt, popt = JaxSparseOptimizer(kind, CFGS[kind]), SparseOptimizer(
        kind, CFGS[kind])
    w = r.normal(size=(6, DIM)).astype(np.float32)
    jw, pw = jnp.asarray(w), torch.from_numpy(w)
    jst, pst = jopt.init_state(6, DIM), popt.init_state(6, DIM)
    widths = [n for n, _ in popt.row_state_widths(DIM)]
    for step in range(3):
        g = r.normal(size=(6, DIM)).astype(np.float32)
        lr = 0.1 * (step + 1)
        jw, js, jsc = jopt.apply_rows(
            jw, {n: jst[n] for n in widths}, jnp.asarray(g), lr,
            {k: v for k, v in jst.items() if k not in widths})
        pw, ps, psc = popt.apply_rows(
            pw, {n: pst[n] for n in widths}, torch.from_numpy(g), lr,
            {k: v for k, v in pst.items() if k not in widths})
        jst, pst = {**js, **jsc}, {**ps, **psc}
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **TOL)
        for k in jst:
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_apply_matches_jax_over_3_steps(kind):
    """``apply`` on a table: sorted unique ids with a dropped out-of-range
    sentinel tail, as the JAX engine passes them."""
    r = np.random.default_rng(1)
    jopt, popt = JaxSparseOptimizer(kind, CFGS[kind]), SparseOptimizer(
        kind, CFGS[kind])
    w0 = r.normal(size=(ROWS, DIM)).astype(np.float32)
    jw, pw = jnp.asarray(w0), torch.from_numpy(w0.copy())
    jst, pst = jopt.init_state(ROWS, DIM), popt.init_state(ROWS, DIM)
    touched = set()
    for _ in range(3):
        uids = np.sort(r.choice(ROWS, size=5, replace=False)).astype(np.int32)
        touched |= set(uids.tolist())
        uids = np.concatenate([uids, [ROWS, ROWS]]).astype(np.int32)
        g = r.normal(size=(7, DIM)).astype(np.float32)
        jw, jst = jopt.apply(jw, jst, jnp.asarray(uids), jnp.asarray(g), 0.5)
        popt.apply(pw, pst, torch.from_numpy(uids), torch.from_numpy(g), 0.5)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **TOL)
        for k in jst:
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                       err_msg=k, **TOL)
    rest = sorted(set(range(ROWS)) - touched)
    np.testing.assert_array_equal(pw.numpy()[rest], w0[rest])


@pytest.mark.parametrize("kind", ["lars_sgd", "lamb", "partial_rowwise_lamb",
                                  "partial_rowwise_adam", "adadelta",
                                  "rmsprop"])
def test_queued_kinds_raise(kind):
    with pytest.raises(NotImplementedError, match="not ported"):
        SparseOptimizer(kind, {"lr": 0.1})


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        SparseOptimizer("nope", {})


def _engine(kind="rowwise_adagrad"):
    tables = [TableSpec("a", 10, DIM), TableSpec("b", 20, DIM),
              TableSpec("c", 5, 4)]
    lookups = [
        LookupSpec("a:f1", "f1", "a", "sum"),
        LookupSpec("b:f2", "f2", "b", "mean"),
        LookupSpec("b:s1:seq", "s1", "b", "none", True),
        LookupSpec("c:f3", "f3", "c", "sum"),
    ]
    eng = EmbeddingEngine(tables, lookups, SparseOptimizer(kind, CFGS[kind]))
    g = torch.Generator().manual_seed(0)
    fused = {gk: torch.randn(grp.total_rows, grp.dim, generator=g)
             for gk, grp in eng.groups.items()}
    return eng, fused


def _batch():
    sparse = {
        # fixed [B, L] with a -1 padding id and a duplicate
        "f1": SparseField(torch.tensor([[1, 1, -1], [3, 9, 1]],
                                       dtype=torch.int32)),
        # jagged, padded to 8 slots
        "f2": SparseField(
            torch.tensor([0, 5, 5, 19, -1, -1, -1, -1], dtype=torch.int32),
            lengths=torch.tensor([3, 1], dtype=torch.int32)),
        "f3": SparseField(torch.tensor([[4], [4]], dtype=torch.int32)),
    }
    seq = {"s1": SparseField(
        torch.tensor([[5, 7, -1], [0, -1, -1]], dtype=torch.int32),
        lengths=torch.tensor([2, 1], dtype=torch.int32))}
    return sparse, seq


def test_engine_groups_tables_by_dim():
    eng, fused = _engine()
    assert set(eng.groups) == {f"d{DIM}", "d4"}
    assert eng.table_rows("a") == (f"d{DIM}", 0, 10)
    assert eng.table_rows("b") == (f"d{DIM}", 10, 20)
    assert fused[f"d{DIM}"].shape == (30, DIM)
    assert eng.extract_table(fused, "b").data_ptr() == fused[f"d{DIM}"][10:].data_ptr()


def test_engine_lookup_pools_and_masks_padding():
    eng, fused = _engine()
    sparse, seq = _batch()
    out, res = eng.lookup(fused, sparse, seq)
    a, b = eng.extract_table(fused, "a"), eng.extract_table(fused, "b")
    np.testing.assert_allclose(out["a:f1"][0].numpy(), (2 * a[1]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(out["a:f1"][1].numpy(),
                               (a[3] + a[9] + a[1]).numpy(), rtol=1e-6)
    np.testing.assert_allclose(out["b:f2"][0].numpy(),
                               ((b[0] + 2 * b[5]) / 3).numpy(), rtol=1e-6)
    np.testing.assert_allclose(out["b:f2"][1].numpy(), b[19].numpy(),
                               rtol=1e-6)
    assert out["b:s1:seq"].shape == (2, 3, DIM)
    assert torch.equal(out["b:s1:seq"][0, 1], b[7])
    assert (out["b:s1:seq"][0, 2] == 0).all()
    flat_ids, _ = res[f"d{DIM}"]
    # ids are offset into the fused table; padding stays -1
    assert flat_ids.tolist()[:6] == [1, 1, -1, 3, 9, 1]
    assert flat_ids.tolist()[6:10] == [10, 15, 15, 29]


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_engine_update_equals_dense_gradient_step(kind):
    """The row-sparse update equals the optimizer applied to the dense
    table gradient that autograd gives, on the touched rows; every other
    row, and its state, keeps its bits."""
    eng, fused = _engine(kind)
    sparse, seq = _batch()
    state = eng.init_opt_state()
    before = {k: v.clone() for k, v in fused.items()}
    state_before = {gk: {k: v.clone() for k, v in st.items()}
                    for gk, st in state.items()}

    # dense reference: autograd through the lookup itself
    dense = {k: v.clone().requires_grad_(True) for k, v in fused.items()}
    out_d, _ = eng.lookup(dense, sparse, seq)
    g = torch.Generator().manual_seed(1)
    ups = {k: torch.randn(v.shape, generator=g) for k, v in out_d.items()}
    loss = sum((out_d[k] * ups[k]).sum() for k in out_d)
    dgrads = torch.autograd.grad(loss, list(dense.values()))

    out, res = eng.lookup(fused, sparse, seq)
    eng.update(fused, state, res, ups, lr_scale=0.5)

    for (gk, w), dg in zip(before.items(), dgrads):
        touched = dg.abs().sum(dim=1) > 0
        uids = touched.nonzero()[:, 0]
        ref_w = w.clone()
        ref_st = {k: v.clone() for k, v in state_before[gk].items()}
        eng.optimizer.apply(ref_w, ref_st, uids, dg[uids],
                            0.5 * eng.optimizer.base_lr)
        np.testing.assert_allclose(fused[gk].numpy(), ref_w.numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(fused[gk][~touched], w[~touched])
        assert not torch.equal(fused[gk][touched], w[touched])
        for k, v in state[gk].items():
            np.testing.assert_allclose(v.numpy(), ref_st[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            if v.dim() >= 1:
                assert torch.equal(v[~touched], state_before[gk][k][~touched])


def test_engine_update_with_only_padding_ids_changes_nothing():
    eng, fused = _engine("adagrad")
    sparse = {
        "f1": SparseField(torch.full((2, 3), -1, dtype=torch.int32)),
        "f2": SparseField(torch.full((8,), -1, dtype=torch.int32),
                          lengths=torch.zeros(2, dtype=torch.int32)),
        "f3": SparseField(torch.full((2, 1), -1, dtype=torch.int32)),
    }
    seq = {"s1": SparseField(torch.full((2, 3), -1, dtype=torch.int32),
                             lengths=torch.zeros(2, dtype=torch.int32))}
    state = eng.init_opt_state()
    before = {k: v.clone() for k, v in fused.items()}
    out, res = eng.lookup(fused, sparse, seq)
    assert all((v == 0).all() for v in out.values())
    eng.update(fused, state, res,
               {k: torch.ones_like(v) for k, v in out.items()}, 1.0)
    for k in fused:
        assert torch.equal(fused[k], before[k])
        assert (state[k]["acc"] == 0.1).all()


def test_engine_update_without_output_gradients_is_a_no_op():
    eng, fused = _engine("adam")
    sparse, seq = _batch()
    state = eng.init_opt_state()
    before = {k: v.clone() for k, v in fused.items()}
    _, res = eng.lookup(fused, sparse, seq)
    eng.update(fused, state, res, {}, 1.0)
    for k in fused:
        assert torch.equal(fused[k], before[k])
        assert int(state[k]["step"]) == 0


def test_extract_table_state_slices_rows_and_keeps_scalars():
    eng, fused = _engine("adam")
    state = eng.init_opt_state()
    state[f"d{DIM}"]["m"][10:30] = 1.0
    st = eng.extract_table_state(fused, state, "b")
    assert st["m"].shape == (20, DIM) and (st["m"] == 1).all()
    assert (eng.extract_table_state(fused, state, "a")["m"] == 0).all()
    assert st["step"].dim() == 0

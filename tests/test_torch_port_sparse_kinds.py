"""The six sparse optimizers of the optimizer slice (lars_sgd, lamb,
partial_rowwise_lamb, partial_rowwise_adam, adadelta, rmsprop), table
init functions and BF16/FP16 tables, through the whole DeepFM train
step, against the JAX package (CPU, one config text and the same Arrow
columns; the JAX weights cross through utils/convert.py).

- Each kind, the port's engine packed and unpacked, 3 steps: tables and
  each table's optimizer state within 1e-5 of each tensor's largest
  magnitude, dense parameters within 1e-4 (adam divides by the root of
  the second moment; the same fp32 formulas in another library; the
  packed merge adds a rounded difference, about 1 ulp). rmsprop runs at
  eps 1e-4 (see ``NEW_KINDS``).
- The packed layouts: the slot and rows per 128-lane row of each kind at
  dim 16 and at dim 4 (a slot over 128 lanes stays unpacked), equal to
  the JAX engine's; lamb's and lars's row norms read the weight lanes of
  a packed row only.
- BF16 and FP16 tables, 2 steps: stored in their dtype and unpacked in
  both packages, the lookups and the gradients of their outputs in that
  dtype, the tables and their fp32 row state within one unit in the
  last place of the storage dtype of each tensor's max (both round to
  nearest; one fp32 ulp apart before it, a rounding can flip), the dense
  parameters (dense sgd) within 1e-4.
- init_fn and wide_init_fn: the statistics of each distribution, and
  ``constant`` exact."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    PairedTrainers,
    assert_state_matches_jax,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
)
from torcheasyrec_tpu.parallel import emb_engine as jax_engine
from torcheasyrec_tpu.parallel.sparse_optim import (
    SparseOptimizer as JaxSparseOptimizer,
)
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.parallel.emb_engine import (
    EmbeddingEngine,
    TableSpec,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

BATCH = 64
TABLES = deepfm_table_names()
NEW_KINDS = {
    "lars_sgd": "lars_sgd_optimizer { lr: 0.5 momentum: 0.8 eta: 0.01 }",
    "lamb": "lamb_optimizer { lr: 0.01 }",
    "partial_rowwise_lamb":
        "partial_rowwise_lamb_optimizer { lr: 0.01 weight_decay: 0.01 }",
    "partial_rowwise_adam":
        "partial_rowwise_adam_optimizer { lr: 0.01 weight_decay: 0.01 }",
    "adadelta": "adadelta_optimizer { lr: 1.0 rho: 0.9 }",
    # eps 1e-4: rows whose gradient nearly cancels (1e-9 of the others)
    # take steps of lr g / (|g| sqrt(1 - alpha) + eps); at the default
    # eps 1e-8 that turns the two libraries' rounding of such a g (0.4%
    # apart) into differences of 2e-5 of the table's max
    "rmsprop": "rmsprop_optimizer { lr: 0.01 alpha: 0.9 eps: 1e-4 }",
}
# (slot, rows per physical row) at dim 16 and dim 4
LAYOUTS = {
    "adam": ((48, 2), (12, 10)), "lamb": ((48, 2), (12, 10)),
    "adadelta": ((48, 2), (12, 10)),
    "partial_rowwise_adam": ((33, 3), (9, 14)),
    "partial_rowwise_lamb": ((33, 3), (9, 14)),
    "lars_sgd": ((32, 4), (8, 16)), "rmsprop": ((32, 4), (8, 16)),
}


def _run_both(text, n_steps, **engine_options):
    """The JAX state and the port's (model, state) after ``n_steps`` steps
    from the same weights over the same batches."""
    pair = PairedTrainers(text, TABLES, ["label"], **engine_options)
    for i in range(n_steps):
        jmetrics, metrics = pair.step(deepfm_cols(BATCH, seed=20 + i))
        np.testing.assert_allclose(float(metrics["total_loss"]),
                                   float(jmetrics["total_loss"]), rtol=1e-4)
    return pair.jmodel, pair.jstate, pair.model, pair.state


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("kind", sorted(NEW_KINDS))
def test_deepfm_three_steps_match_jax(kind, packed):
    text = deepfm_config_text(BATCH, sparse_opt=NEW_KINDS[kind])
    jmodel, jstate, model, state = _run_both(text, 3, packed=packed)
    groups = model.embedding_group.engine.groups
    assert all(g.packed == packed for g in groups.values())
    assert_state_matches_jax(model, state, jmodel, jstate, TABLES, tol=1e-5,
                             param_tol=1e-4)


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_packed_layouts_match_jax(kind, monkeypatch):
    monkeypatch.setenv("TZREC_PACKED", "1")
    specs = [("a", 1000, 16), ("b", 700, 4), ("c", 90, 64)]
    jeng = jax_engine.EmbeddingEngine(
        [jax_engine.TableSpec(n, r, d, sharding="data_parallel")
         for n, r, d in specs], [],
        optimizer=JaxSparseOptimizer(kind, {"lr": 0.1}))
    peng = EmbeddingEngine([TableSpec(n, r, d) for n, r, d in specs], [],
                           SparseOptimizer(kind, {"lr": 0.1}))
    jgroups = {f"d{g.dim}": g for g in jeng.groups.values()}
    for gk, want in zip(("d16", "d4"), LAYOUTS[kind]):
        pg, jg = peng.groups[gk], jgroups[gk]
        assert pg.packed and jg.packed
        assert (pg.slot, pg.spr) == (jg.slot, jg.spr) == want
        assert (pg.p_rows, pg.total_rows) == (jg.p_rows, jg.padded_rows)
    # dim 64: a slot over 128 lanes (192 or 129) stays unpacked
    assert peng.groups["d64"].packed == jgroups["d64"].packed == (
        kind in ("lars_sgd", "rmsprop"))


@pytest.mark.parametrize("kind", ["lamb", "lars_sgd", "partial_rowwise_lamb"])
def test_row_norms_read_the_weight_lanes_only(kind):
    """A packed row's update equals the unpacked one's when the state
    lanes beside the weights hold large values: the norms of lamb and
    lars take the ``dim`` weight lanes only."""
    opt = SparseOptimizer(kind, {"lr": 0.1})
    eng = EmbeddingEngine([TableSpec("t", 12, 16)], [], opt)
    g = eng.groups["d16"]
    assert g.packed
    r = np.random.default_rng(0)
    w = torch.from_numpy(r.normal(size=(12, 16)).astype(np.float32))
    srows = {name: torch.full((12, width), 1e3)
             for name, width in g.state_widths}
    rowv = torch.cat([w] + [srows[n] for n, _ in g.state_widths], dim=1)
    grads = torch.from_numpy(r.normal(size=(12, 16)).astype(np.float32))
    scalar = opt.scalar_state_init()
    new_slot, _ = eng._apply_slots(g, rowv, grads, 0.1, dict(scalar))
    new_rows, new_srows, _ = opt.apply_rows(w, srows, grads, 0.1,
                                            dict(scalar))
    torch.testing.assert_close(new_slot[:, :16], new_rows, rtol=0, atol=0)
    # and the JAX package's rows from the weights alone
    jrows, _, _ = JaxSparseOptimizer(kind, {"lr": 0.1}).apply_rows(
        w.numpy(), {k: v.numpy() for k, v in srows.items()}, grads.numpy(),
        0.1, {k: np.asarray(v) for k, v in scalar.items()})
    np.testing.assert_allclose(new_rows.numpy(), np.asarray(jrows),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["adam", "partial_rowwise_lamb"])
@pytest.mark.parametrize("data_type", ["BF16", "FP16"])
def test_low_precision_tables_two_steps_match_jax(data_type, kind):
    # adam at eps 1e-4: a row whose gradient cancels sums to 0 in one
    # package and to 1e-7 of rounding in the other, which adam at eps
    # 1e-8 turns into a step of lr (2.5% of cat_2_emb's max in bf16)
    sparse_opt = {"adam": "adam_optimizer { lr: 0.01 eps: 1e-4 }",
                  "partial_rowwise_lamb": NEW_KINDS["partial_rowwise_lamb"]}
    # dense sgd: the step-1 tables differ by flipped roundings, and adam
    # would turn the step-2 gradients' differences into lr-sized moves
    text = deepfm_config_text(
        BATCH, sparse_opt=sparse_opt[kind],
        dense_opt="sgd_optimizer { lr: 0.05 } constant_learning_rate {}",
        feature_extra=f'data_type: "{data_type}" ')
    jmodel, jstate, model, state = _run_both(text, 2)
    dtype = {"BF16": torch.bfloat16, "FP16": torch.float16}[data_type]
    eng = model.embedding_group.engine
    for gk, g in eng.groups.items():
        assert not g.packed and g.store_dtype == dtype
        assert model.embedding_group.engine_tables()[gk].dtype == dtype
    # the spacing of the storage dtype at x is at most x * 2^-7 (bf16)
    # or x * 2^-10 (fp16)
    ulp = {"BF16": 2.0 ** -7, "FP16": 2.0 ** -10}[data_type]
    assert_state_matches_jax(model, state, jmodel, jstate, TABLES, tol=ulp,
                             param_tol=1e-4)
    fused = model.embedding_group.engine_tables()
    for n in TABLES:
        assert eng.extract_table(fused, n).dtype == dtype
        st = eng.extract_table_state(fused, state["sparse_opt"], n)
        assert all(v.dtype == torch.float32 for k, v in st.items()
                   if k != "step")


INIT_CASES = {
    "nn.init.uniform_,a=-0.3,b=0.1": (-0.1, 0.4 / 12 ** 0.5, -0.3, 0.1),
    "nn.init.normal_,mean=0.5,std=0.2": (0.5, 0.2, None, None),
    "nn.init.trunc_normal_,std=0.05": (0.0, 0.05, None, None),
    "nn.init.xavier_uniform_": (0.0, (2.0 / (3000 + 8)) ** 0.5 / 1.0,
                                -(6.0 / 3008) ** 0.5, (6.0 / 3008) ** 0.5),
    "nn.init.kaiming_normal_": (0.0, (2.0 / 3000) ** 0.5, None, None),
    "nn.init.constant_,val=0.25": (0.25, 0.0, 0.25, 0.25),
    "nn.init.zeros_": (0.0, 0.0, 0.0, 0.0),
}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("spec", sorted(INIT_CASES))
def test_init_fn_statistics(spec, packed):
    """A table's ``init_fn``: the 3000 x 8 table ``cat_0_emb`` holds the
    distribution's mean and standard deviation (4 standard errors) within
    its bounds (``constant`` and ``zeros`` exactly); the state lanes of a
    packed table keep the optimizer's fill; the other tables keep the
    default uniform(+-1/sqrt(rows))."""
    text = deepfm_config_text(BATCH).replace(
        'feature_name: "cat_0" num_buckets: 3000 embedding_dim: 8',
        f'feature_name: "cat_0" num_buckets: 3000 embedding_dim: 8 '
        f'init_fn: "{spec}"')
    model, _, _ = port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu", packed=packed)
    t = model.embedding_group.tables["cat_0_emb"].numpy()
    mean, std, lo, hi = INIT_CASES[spec]
    if std == 0.0:
        assert (t == mean).all()
    else:
        se = std / t.size ** 0.5
        assert abs(t.mean() - mean) < 4 * se
        assert abs(t.std() - std) < 0.05 * std
        if lo is not None:
            assert lo <= t.min() and t.max() <= hi
    other = model.embedding_group.tables["cat_3_emb"].numpy()
    assert np.abs(other).max() <= 2000 ** -0.5
    assert np.abs(other).max() > 0.9 * 2000 ** -0.5
    eng = model.embedding_group.engine
    acc = eng.extract_table_state(model.embedding_group.engine_tables(),
                                  model.embedding_group.init_opt_state(),
                                  "cat_0_emb")["acc"]
    assert (acc == 0).all()


def test_wide_init_fn_and_unknown_init():
    text = deepfm_config_text(BATCH, wide_extra='wide_init_fn: '
                              '"nn.init.constant_,val=0.125"')
    model, _, _ = port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu")
    tables = model.embedding_group.tables
    for n in TABLES:
        if n.endswith("__wide"):
            assert (tables[n] == 0.125).all(), n
        else:
            assert not (tables[n] == 0.125).any(), n
    with pytest.raises(ValueError, match="unknown init fn"):
        port_main._build_model_and_optim(parse_pipeline_config(
            text.replace("constant_,val=0.125", "orthogonal_")), "cpu")

"""The rest of the ranking and multi-task zoo of the port against the JAX
package (fp32, CPU; one config text and the same Arrow columns for both;
the JAX weights cross through utils/convert.py).

- Per module: CIN, WuKong's LinearCompressBlock, FactorizationMachineBlock
  and WuKongLayer (with and without the residual projection),
  InputSENet, GateNU, EPNet, PPNet and Intervention: the forward within
  rtol 1e-5 / atol 1e-6. Batch norm over 2-D and 3-D inputs, in training
  (batch statistics, the running statistics' update, the gradients) and
  in eval; Dice and PReLU (output, gradients, Dice's statistics);
  variational dropout with given noise, in eval and embedding-wise
  (output, regularisation term, gradients); the Pareto loss weights with
  floors, all clipped to 0 and all at their floors.
- Per model (xDeepFM with batch norm, WuKong with PReLU and variational
  dropout, PEPNet with Pareto loss weights, DC2VR with Dice and a task
  space, and MultiTowerDIN with Dice in its attention MLP over [B, L, 4D]),
  narrowed from the criteo_synth-shaped configs of ``chip_smoke.py``'s
  ``train_zoo_rest``: the build, every parameter's JAX path and a strict
  ``load_state_dict``; the forward within rtol 1e-5 / atol 1e-6; two
  train steps (the JAX package's running statistics folded in after each,
  as its ``train_and_evaluate`` does; the variational-dropout noise of
  the JAX step given to the port) within rtol 1e-4 / atol 1e-5: losses,
  dense parameters, batch-norm statistics, tables and row state.
- Batch norm forced on every MLP of eight models: the running statistics
  after one step equal the JAX package's folded ones.
- Variational dropout on DeepFM and DSSM, and Pareto weights with a
  task space on MMoE: two steps' losses (``<group>_feature_p_loss``
  included) and state.
- ``train_and_evaluate`` of WuKong with variational dropout in both
  packages (the port fed the JAX loop's noise); ``feature_selection``
  against the JAX tool's ranking and rewritten config.

Adam's eps is 1e-4 in the parity configs: a linear followed by batch
norm has a bias whose gradient is 0 up to rounding, which adam at its
default eps turns into lr-sized steps of either sign (ROADMAP §3). The
JAX engine's co-keyed table merge is off and its dense lane takes the
tables of at most ``ZOO_DENSE_LANE`` rows, as the port's."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from test_torch_port_match import (
    LABELS as MATCH_LABELS,
    _samplers,
    _table_names as match_table_names,
    files,  # noqa: F401 (the retrieval files fixture)
    match_cols,
    match_config_text,
)
from torch_port_helpers import (
    ZOO_DENSE_LANE,
    converted_state,
    deepfm_cols,
    deepfm_config_text,
    deepfm_table_names,
    jax_model_and_state,
    jax_train_setup,
    zoo_cols,
    zoo_config_text,
    zoo_table_names,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.losses import pe_mtl_loss as jax_pe
from torcheasyrec_tpu.modules import activation as jax_activation
from torcheasyrec_tpu.modules import interaction as jax_interaction
from torcheasyrec_tpu.modules import intervention as jax_intervention
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules import personalized_net as jax_pn
from torcheasyrec_tpu.modules import variational_dropout as jax_vd
from torcheasyrec_tpu.optim import optimizer_builder as jax_builder
from torcheasyrec_tpu.tools import feature_selection as jax_fs
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.losses import pe_mtl_loss
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules import activation, interaction
from torcheasyrec_tpu_torch.modules import intervention, personalized_net
from torcheasyrec_tpu_torch.modules import variational_dropout
from torcheasyrec_tpu_torch.modules.module import BatchNorm
from torcheasyrec_tpu_torch.tools import feature_selection
from torcheasyrec_tpu_torch.utils import convert
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 64
LABELS = ["label", "conversion"]
N_STEPS = 2
CLASSES = {"xdeepfm": "XDeepFM", "wukong": "WuKong", "pepnet": "PEPNet",
           "dc2vr": "DC2VR", "multi_tower_din_dice": "MultiTowerDIN"}
VD_LOW, VD_HIGH = 1e-6, 1 - 1e-6  # the JAX package's noise range


@pytest.fixture(scope="module")
def jax_engine_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TZREC_TABLE_MERGE", "0")
        mp.setenv("TZREC_DENSE_LANE", str(ZOO_DENSE_LANE))
        mp.setenv("TZREC_PACKED", "1")
        yield


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _perturb(tree, scale=0.05):
    """Every leaf moved by a fixed pattern, so that zero-initialised
    parameters (Dice's alpha, biases) and the unit statistics of a
    batch norm take part."""
    def move(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a + scale * np.sin(np.arange(a.size) + 1.0)
                           .reshape(a.shape).astype(np.float32))
    return jax.tree_util.tree_map(move, tree)


def _load(module, jparams):
    module.load_state_dict(
        convert.from_jax_state(jax.device_get(jparams), {}), strict=True)
    return module


def _close(got, ref, tol=FWD_TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, err_msg=name, **tol)


# --- modules ----------------------------------------------------------------

_MLP = {"hidden_units": [8]}


def _module_case(name):
    g = torch.Generator().manual_seed(0)
    key = jax.random.key(1)
    ctx, dt = JM.eval_ctx(), torch.float32
    x = _x(8, 5, 4)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if name == "cin":
        jm = jax_interaction.CIN(5, [6, 4, 3])
        p = jm.init(key)
        m = _load(interaction.CIN(5, [6, 4, 3], g), p)
        return m(tx, dt), jm(p, jx, ctx)
    if name == "linear_compress_block":
        jm = jax_interaction.LinearCompressBlock(5, 3)
        p = jm.init(key)
        m = _load(interaction.LinearCompressBlock(5, 3, g), p)
        return m(tx, dt), jm(p, jx, ctx)
    if name == "factorization_machine_block":
        jm = jax_interaction.FactorizationMachineBlock(5, 4, 3, 2, _MLP)
        p = _perturb(jm.init(key))
        m = _load(interaction.FactorizationMachineBlock(5, 4, 3, 2, _MLP, g),
                  p)
        return m(tx, dt), jm(p, jx, ctx)
    if name in ("wukong_layer_residual_proj", "wukong_layer_identity"):
        lcb = 3 if name.endswith("proj") else 2
        jm = jax_interaction.WuKongLayer(5, 4, lcb, 3, 2, _MLP)
        p = _perturb(jm.init(key))
        m = _load(interaction.WuKongLayer(5, 4, lcb, 3, 2, _MLP, g), p)
        assert (m.residual_proj is None) == ("residual_proj" not in p)
        return m(tx, dt), jm(p, jx, ctx)
    if name == "input_senet":
        xs = [_x(8, d, seed=i) for i, d in enumerate((4, 4, 6, 2))]
        jm = jax_interaction.InputSENet([4, 4, 6, 2])
        p = jm.init(key)
        m = _load(interaction.InputSENet([4, 4, 6, 2], g), p)
        got = m([torch.from_numpy(a) for a in xs], dt)
        ref = jm(p, [jnp.asarray(a) for a in xs], ctx)
        return torch.cat(got, -1), jnp.concatenate(ref, -1)
    x2, d2 = _x(8, 12), _x(8, 6, seed=1)
    if name == "gate_nu":
        jm = jax_pn.GateNU(12, 16, 7, gamma=1.5)
        p = jm.init(key)
        m = _load(personalized_net.GateNU(12, 16, 7, g, 1.5), p)
        return m(torch.from_numpy(x2), dt), jm(p, jnp.asarray(x2), ctx)
    if name == "epnet":
        jm = jax_pn.EPNet(12, 6, 16, gamma=2.0)
        p = jm.init(key)
        m = _load(personalized_net.EPNet(12, 6, 16, g, 2.0), p)
        return (m(torch.from_numpy(x2), torch.from_numpy(d2), dt),
                jm(p, jnp.asarray(x2), jnp.asarray(d2), ctx))
    if name == "ppnet":
        jm = jax_pn.PPNet(12, 6, [16, 8], "nn.ReLU", (), 2.0)
        p = jm.init(key)
        m = _load(personalized_net.PPNet(12, 6, [16, 8], g), p)
        return (m(torch.from_numpy(x2), torch.from_numpy(d2), dt),
                jm(p, jnp.asarray(x2), jnp.asarray(d2), ctx))
    if name == "intervention":
        jm = jax_intervention.Intervention(12, 6, 3, dropout_ratio=0.0)
        p = jm.init(key)
        m = _load(intervention.Intervention(12, 6, 3, g, 0.0), p)
        return (m(torch.from_numpy(x2), torch.from_numpy(d2), dt),
                jm(p, jnp.asarray(x2), jnp.asarray(d2), ctx))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "cin", "linear_compress_block", "factorization_machine_block",
    "wukong_layer_residual_proj", "wukong_layer_identity", "input_senet",
    "gate_nu", "epnet", "ppnet", "intervention"])
def test_module_matches_jax(name):
    got, ref = _module_case(name)
    _close(got, ref)


def _projection(shape, seed=9):
    return _x(*shape, seed=seed)


def _grads_of(fn_torch, fn_jax, x, params_j, shape):
    """d sum(out * r) / d(x, params) of both packages, r a fixed random
    projection (a plain sum of a normalised output has no gradient)."""
    r = _projection(shape)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn_torch(xt)
    (out * torch.from_numpy(r)).sum().backward()

    def loss(xj, pj):
        return jnp.sum(fn_jax(xj, pj) * r)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params_j)
    return out, xt.grad, gx, gp


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(rank, training):
    """The JAX batch norm in training (biased batch statistics over every
    leading axis, running statistics moved by 0.1 towards them, the
    biased variance included) and in eval (the running statistics):
    output, statistics and gradients."""
    shape = (16, 6) if rank == 2 else (8, 5, 6)
    x = _x(*shape) * 2.0 + 0.5
    p = _perturb(JM.batch_norm_init(6))
    bn = _load(BatchNorm(6), p).train(training)
    ctx = JM.Context(training=training, rng=jax.random.key(0))

    def fn_jax(xj, pj):
        return JM.batch_norm_apply(pj, xj, ctx, "bn")

    out, gx_t, gx, gp = _grads_of(bn, fn_jax, x, p, shape)
    _close(out, fn_jax(jnp.asarray(x), p))
    _close(gx_t, gx, name="grad x")
    _close(bn.weight.grad, gp["scale"], name="grad scale")
    _close(bn.bias.grad, gp["bias"], name="grad bias")
    if training:
        upd = jax.device_get(ctx.state_updates["bn"])
        _close(bn.mean, upd["mean"], name="mean")
        _close(bn.var, upd["var"], name="var")
    else:
        assert not ctx.state_updates
        _close(bn.mean, p["mean"])
        _close(bn.var, p["var"])


@pytest.mark.parametrize("case", ["dice_train", "dice_eval", "prelu"])
def test_parameterised_activation_matches_jax(case):
    name = "nn.Dice" if case.startswith("dice") else "nn.PReLU"
    training = case != "dice_eval"
    x = _x(16, 6) * 1.5
    p = _perturb(jax_activation.init_activation(name, 6, jax.random.key(0)))
    act = activation.create_activation(name, 6)
    _load(act, p).train(training)
    ctx = JM.Context(training=training, rng=jax.random.key(0))

    def fn_jax(xj, pj):
        return jax_activation.apply_activation(name, pj, xj, ctx, "act")

    out, gx_t, gx, gp = _grads_of(act, fn_jax, x, p, (16, 6))
    _close(out, fn_jax(jnp.asarray(x), p))
    _close(gx_t, gx, name="grad x")
    _close(act.alpha.grad, gp["alpha"], name="grad alpha")
    if case == "dice_train":
        upd = jax.device_get(ctx.state_updates["act.bn"])
        _close(act.bn.mean, upd["mean"], name="mean")
        _close(act.bn.var, upd["var"], name="var")
    assert activation.act_needs_params(name)
    with pytest.raises(ValueError, match="create_activation"):
        activation.get_activation(name)


def test_prelu_keeps_one_alpha_per_channel():
    act = activation.create_activation("nn.PReLU", 3)
    act.alpha.data = torch.tensor([0.1, 0.2, 0.3])
    x = torch.tensor([[-1.0, -1.0, -1.0], [2.0, 0.0, -2.0]])
    assert torch.equal(act(x), torch.tensor(
        [[-0.1, -0.2, -0.3], [2.0, 0.0, -0.6]]))


@pytest.mark.parametrize("case", ["given_noise", "eval", "embedding_wise"])
def test_variational_dropout_matches_jax(case):
    dims = [4, 2, 3]
    wise = case == "embedding_wise"
    training = case != "eval"
    jm = jax_vd.VariationalDropout(dims, 0.03, embedding_wise=wise)
    p = {"logit_p": jnp.asarray(np.linspace(-3.0, 1.0, jm.n), jnp.float32)}
    m = _load(variational_dropout.VariationalDropout(dims, 0.03, wise), p)
    rng = jax.random.key(5)
    # the JAX module's draw: the context's first key
    u = jax.random.uniform(jax.random.fold_in(rng, 1), (jm.n,),
                           minval=VD_LOW, maxval=VD_HIGH)
    x = _x(8, 9)
    r = _projection((8, 9))

    def jloss(xj, pj):
        ctx = JM.Context(training=training, rng=rng)
        out, reg = jm(pj, xj, ctx)
        return jnp.sum(out * r) + reg, (out, reg)

    (_, (jout, jreg)), (gx, gp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, reg = m(xt, training, u=torch.from_numpy(np.array(u)))
    ((out * torch.from_numpy(r)).sum() + reg).backward()
    _close(out, jout)
    _close(reg, jreg)
    _close(xt.grad, gx, name="grad x")
    _close(m.logit_p.grad, gp["logit_p"], name="grad logit_p")
    _close(m.drop_probabilities(), jm.drop_probabilities(p))


def test_variational_dropout_draws_from_the_generator():
    m = variational_dropout.VariationalDropout([2, 3], 0.01)
    x = torch.ones(4, 5)
    a = m(x, True, torch.Generator().manual_seed(3))[0]
    b = m(x, True, torch.Generator().manual_seed(3))[0]
    c = m(x, True, torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    u = variational_dropout.draw_noise(10_000, torch.Generator())
    assert VD_LOW <= float(u.min()) and float(u.max()) <= VD_HIGH
    with pytest.raises(ValueError, match="generator"):
        m(x, True)


_PARETO_CASES = {
    "two": ({"a": 0.7, "b": 0.2}, {}),
    "floors": ({"a": 1.3, "b": 0.4, "c": 0.05}, {"a": 0.3, "c": 0.1}),
    # one step puts every weight at 0: the uniform weights
    "all_clipped": ({f"l{i}": 0.5 for i in range(5)}, {}),
    # the floors outweigh the simplex: every weight at its floor
    "all_floored": ({"a": 0.9, "b": 0.3, "c": 0.6},
                    {"a": 0.5, "b": 0.5, "c": 0.5}),
}


@pytest.mark.parametrize("case", sorted(_PARETO_CASES))
def test_pareto_weights_match_jax(case):
    losses, floors = _PARETO_CASES[case]
    ref = jax_pe.pareto_loss_weights(
        {k: jnp.float32(v) for k, v in losses.items()}, floors)
    got = pe_mtl_loss.pareto_loss_weights(
        {k: torch.tensor(v) for k, v in losses.items()}, floors)
    assert list(got) == sorted(losses) == list(ref)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    mean = np.mean([float(v) for v in got.values()])
    np.testing.assert_allclose(mean, 1.0, rtol=1e-6)
    if case in ("all_clipped", "all_floored"):
        assert all(abs(float(v) - 1.0) < 1e-6 for v in got.values())


def test_pareto_weights_are_detached():
    a = torch.tensor(0.8, requires_grad=True)
    b = torch.tensor(0.1, requires_grad=True)
    out = pe_mtl_loss.apply_pareto_weights({"a": a, "b": b})
    w = pe_mtl_loss.pareto_loss_weights({"a": a, "b": b})
    sum(out.values()).backward()
    np.testing.assert_allclose(float(a.grad), float(w["a"]), rtol=1e-6)
    np.testing.assert_allclose(float(b.grad), float(w["b"]), rtol=1e-6)


# --- the models -------------------------------------------------------------


def _rest_text(key, batch_size=BATCH, **kw):
    """The narrowed config of ``key`` at adam eps 1e-4."""
    if key == "multi_tower_din_dice":
        text = zoo_config_text("multi_tower_din", batch_size, **kw).replace(
            "attn_mlp { hidden_units: [16, 8] }",
            'attn_mlp { hidden_units: [16, 8] activation: "nn.Dice" }')
        assert "nn.Dice" in text
    else:
        text = zoo_config_text(key, batch_size, **kw)
    return _adam_eps(text)


def _adam_eps(text):
    out = re.sub(r"adam_optimizer \{ lr: ([0-9.e-]+) \}",
                 r"adam_optimizer { lr: \1 eps: 1e-4 }", text)
    assert "eps: 1e-4" in out
    return out


def _rest_tables(key):
    return zoo_table_names("multi_tower_din" if key.startswith(
        "multi_tower_din") else key)


def _port_model(text, **kw):
    cfg = parse_pipeline_config(text)
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, dense_lane_rows=ZOO_DENSE_LANE, **kw)
    return cfg, model, features, sparse_sched


def jax_vd_noise(jmodel, rng):
    """{group: the noise the JAX model's variational dropout draws in a
    train step of ``rng``}: the context's keys 1, 2, ... in group order
    (no other draw comes before them at dropout ratio 0)."""
    return {
        g: torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(rng, i + 1), (vd.n,), minval=VD_LOW,
            maxval=VD_HIGH)))
        for i, (g, vd) in enumerate(jmodel.group_variational_dropouts.items())
    }


class Paired:
    """One config in both packages from the JAX package's initial weights;
    ``step`` runs one train step of each on the same columns, the JAX
    step's running statistics folded into its dense params and its
    variational-dropout noise given to the port."""

    def __init__(self, text, tables, labels, cols_fn):
        _, self.jmodel, jfeatures, self.jstate, self._jstep = (
            jax_train_setup(text))
        self.cfg, self.model, features, sparse_sched = _port_model(text)
        self.tables = tables
        self.model.load_state_dict(converted_state(
            self.jmodel, self.jstate["dense"], self.jstate["tables"],
            tables), strict=True)
        self.jparser = JaxParser(jfeatures, labels=labels)
        self.parser = DataParser(features, labels=labels)
        self.cols_fn = cols_fn
        tx, dense_sched = port_main._dense_optimizer(
            self.model, self.cfg.train_config)
        self.state = port_main._init_state(self.model)
        self._step = port_main.make_train_step(self.model, tx, sparse_sched,
                                               dense_sched)

    def batches(self, seed):
        cols = self.cols_fn(seed)
        return (self.jparser.parse_to_batch(cols),
                self.parser.parse_to_batch(cols))

    def step(self, seed):
        jbatch, batch = self.batches(seed)
        rng = jax.random.key(0)
        self.jstate, jm, updates = self._jstep(self.jstate, jbatch, rng)
        if updates:
            self.jstate["dense"] = jax_main.apply_state_updates(
                self.jstate["dense"], jax.device_get(updates))
        self.model.vd_noise = jax_vd_noise(self.jmodel, rng)
        self.state, m = self._step(self.state, batch)
        self.model.vd_noise = None
        return ({k: float(v) for k, v in jm.items()
                 if not k.startswith("__")},
                {k: float(v) for k, v in m.items()})

    def jax_reference(self):
        """The JAX dense params (statistics folded in) and tables as a
        torch state_dict."""
        eng = self.jmodel.embedding_group.engine
        tables = {n: np.asarray(eng.extract_table(self.jstate["tables"], n))
                  for n in self.tables}
        return convert.from_jax_state(jax.device_get(self.jstate["dense"]),
                                      tables)

    def assert_state_matches(self):
        ref = self.jax_reference()
        sd = self.model.state_dict()
        assert set(sd) == set(ref)
        for n, v in ref.items():
            _close(sd[n].float(), v, TOL, n)
        jeng = self.jmodel.embedding_group.engine
        eg = self.model.embedding_group
        fused = eg.engine_tables()
        for name in self.tables:
            jst = jeng.extract_table_state(
                self.jstate["tables"], self.jstate["sparse_opt"], name)
            st = eg.engine.extract_table_state(
                fused, self.state["sparse_opt"], name)
            assert set(st) == set(jst), name
            for k, v in jst.items():
                v = np.asarray(v)
                _close(st[k].float().reshape(v.shape), v, TOL, f"{name}.{k}")


def _zoo_paired(text, key):
    return Paired(text, _rest_tables(key), LABELS,
                  lambda seed: zoo_cols(BATCH, seed))


@pytest.fixture(scope="module", params=sorted(CLASSES))
def rest_run(request, jax_engine_env):
    """One model in both packages: the eval forward of one batch, then
    two train steps on two more."""
    key = request.param
    pair = _zoo_paired(_rest_text(key), key)
    jbatch, batch = pair.batches(3)
    jpreds, jlosses = jax_main.make_eval_step(pair.jmodel, jnp.float32)(
        {"dense": pair.jstate["dense"], "tables": pair.jstate["tables"]},
        jbatch)
    preds, losses = port_main.make_eval_step(pair.model)(batch)
    steps = [pair.step(100 + i) for i in range(N_STEPS)]
    return dict(key=key, pair=pair, jpreds={k: np.asarray(v) for k, v in
                                            jpreds.items()},
                preds=preds, jlosses=jlosses, losses=losses, steps=steps)


def _bn_stat_paths(jdense):
    return sorted(
        p for p in jax_builder._param_paths(jdense)
        if jax_builder._is_bn_stat(p))


def test_rest_model_builds_from_config_text(rest_run):
    pair = rest_run["pair"]
    model, jmodel = pair.model, pair.jmodel
    assert isinstance(model, BaseModel)
    assert type(model).__name__ == CLASSES[rest_run["key"]]
    assert type(jmodel).__name__ == CLASSES[rest_run["key"]]
    eg, jeg = model.embedding_group, jmodel.embedding_group
    assert eg.group_names() == jeg.group_names()
    for g in eg.group_names():
        assert eg.group_dims(g) == jeg.group_dims(g), g
    assert set(eg.tables) == set(pair.tables)
    # every dense parameter under its JAX path (part optimizers match
    # them); the batch norms' statistics are buffers
    jdense = jax.device_get(pair.jstate["dense"])
    stats = _bn_stat_paths(jdense)
    assert sorted(convert.dense_param_paths(model).values()) == sorted(
        p for p in jax_builder._param_paths(jdense) if p not in stats)
    buffers = sorted(n for n, _ in model.named_buffers()
                     if n.endswith((".mean", ".var")))
    assert len(buffers) == len(stats)
    if rest_run["key"] in ("xdeepfm", "dc2vr", "multi_tower_din_dice"):
        assert stats  # batch norm or Dice
    if rest_run["key"] == "wukong":
        assert sorted(model.variational_dropout) == sorted(
            jmodel.group_variational_dropouts) == ["dense", "sparse"]
        assert model.vd_feature_names == jmodel.vd_feature_names


def test_rest_forward_matches_jax(rest_run):
    preds, jpreds = rest_run["preds"], rest_run["jpreds"]
    assert set(preds) == set(jpreds)
    assert any(k.startswith("probs") for k in preds)
    for k, v in preds.items():
        assert v.dtype == torch.float32 and v.shape == (BATCH,), k
        _close(v, jpreds[k], name=k)
    losses, jlosses = rest_run["losses"], rest_run["jlosses"]
    assert set(losses) == set(jlosses)
    for k in losses:
        _close(losses[k], jlosses[k], name=k)


def test_rest_two_train_steps_match_jax(rest_run):
    for ref, ours in rest_run["steps"]:
        assert set(ours) == set(ref)
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    if rest_run["key"] == "wukong":
        assert {"sparse_feature_p_loss", "dense_feature_p_loss"} <= set(
            rest_run["steps"][0][1])
    rest_run["pair"].assert_state_matches()


# --- batch norm forced on, the loop's options -------------------------------


def _with_bn(text):
    """Every MLP's hidden_units followed by use_bn (not PEPNet's
    ppnet_hidden_units), as the JAX package's test_bn_state_updates_resolve
    forces it."""
    return re.sub(r"(?<!_)hidden_units: (\[[0-9, ]+\])(?! use_bn)",
                  r"hidden_units: \1 use_bn: true", text)


def _match_paired(text):
    """A DSSM pair whose batches take each package's sampler's negatives
    (the same draws) for the same columns."""
    js, ps = _samplers(text)
    pair = Paired(text, match_table_names("dssm"), MATCH_LABELS, None)

    def batches(seed):
        cols = match_cols(32, seed)
        return (pair.jparser.parse_to_batch(js.process(dict(cols))),
                pair.parser.parse_to_batch(ps.process(dict(cols))))

    pair.batches = batches
    return pair


BN_MODELS = ["deepfm", "mmoe", "multi_tower_din", "dssm", "xdeepfm",
             "wukong", "pepnet", "dc2vr"]


@pytest.mark.parametrize("model", BN_MODELS)
def test_bn_running_statistics_match_jax(model, files, jax_engine_env):
    """The port of the JAX package's test_bn_state_updates_resolve: with
    use_bn on every MLP, the running statistics after one step equal the
    JAX ones folded into its params. PEPNet has no MLP (its towers are
    PPNets): no statistics on either side."""
    if model == "deepfm":
        pair = Paired(_with_bn(_adam_eps(deepfm_config_text())),
                      deepfm_table_names(), ["label"],
                      lambda seed: deepfm_cols(BATCH, seed))
    elif model == "dssm":
        pair = _match_paired(_with_bn(match_config_text("dssm", files)))
    else:
        pair = _zoo_paired(_with_bn(_rest_text(model)), model)
    ref, ours = pair.step(7)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    jdense = jax.device_get(pair.jstate["dense"])
    stats = _bn_stat_paths(jdense)
    ref_sd = pair.jax_reference()
    buffers = {n: b for n, b in pair.model.named_buffers()
               if n.endswith((".mean", ".var"))}
    assert len(buffers) == len(stats)
    assert bool(stats) == (model != "pepnet")
    for n, b in buffers.items():
        _close(b, ref_sd[n], TOL, n)
        # the statistics moved from their init
        init = 0.0 if n.endswith(".mean") else 1.0
        assert float((b - init).abs().max()) > 0, n


def test_variational_dropout_on_deepfm_matches_jax(jax_engine_env):
    text = _adam_eps(deepfm_config_text()).replace(
        "  num_class: 1",
        "  variational_dropout { regularization_lambda: 0.05 }\n"
        "  num_class: 1")
    pair = Paired(text, deepfm_table_names(), ["label"],
                  lambda seed: deepfm_cols(BATCH, seed))
    assert sorted(pair.model.variational_dropout) == ["deep", "fm", "wide"]
    for i in range(N_STEPS):
        ref, ours = pair.step(20 + i)
        assert set(ours) == set(ref) == {
            "binary_cross_entropy", "total_loss", "wide_feature_p_loss",
            "fm_feature_p_loss", "deep_feature_p_loss"}
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    pair.assert_state_matches()


def test_variational_dropout_on_dssm_matches_jax(files, jax_engine_env):
    text = match_config_text("dssm", files).replace(
        "  losses { softmax_cross_entropy {} }",
        "  losses { softmax_cross_entropy {} }\n"
        "  variational_dropout { embedding_wise_variational_dropout: true }")
    pair = _match_paired(text)
    assert sorted(pair.model.variational_dropout) == ["item", "user"]
    for i in range(N_STEPS):
        ref, ours = pair.step(30 + i)
        assert {"user_feature_p_loss", "item_feature_p_loss"} <= set(ours)
        assert set(ours) == set(ref)
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    pair.assert_state_matches()


def test_pareto_weights_and_task_space_on_mmoe_match_jax(jax_engine_env):
    text = zoo_config_text("mmoe", BATCH).replace(
        "model_config {", "model_config {\n  use_pareto_loss_weight: true", 1)
    text = text.replace(
        "    mlp { hidden_units: [16, 8] } weight: 0.5\n",
        "    mlp { hidden_units: [16, 8] } weight: 0.5\n"
        '    task_space_indicator_label: "label" in_task_space_weight: 2.0\n'
        "    out_task_space_weight: 0.25 pareto_min_loss_weight: 0.375\n")
    assert "task_space_indicator_label" in text
    pair = _zoo_paired(text, "mmoe")
    assert pair.model._pareto_floors == pair.jmodel._pareto_floors == {
        "binary_cross_entropy_ctr": 0.0, "binary_cross_entropy_cvr": 0.375}
    for i in range(N_STEPS):
        ref, ours = pair.step(40 + i)
        assert set(ours) == set(ref)
        for k in ours:
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)
    pair.assert_state_matches()


def test_task_space_indicator_reads_a_feature(jax_engine_env):
    """An indicator that is no label reads the feature's first value
    (``_grouping_value_dev``), as in the JAX package."""
    text = zoo_config_text("mmoe", BATCH).replace(
        "    mlp { hidden_units: [16, 8] } weight: 0.5\n",
        "    mlp { hidden_units: [16, 8] } weight: 0.5\n"
        '    task_space_indicator_label: "cat_2"\n'
        "    in_task_space_weight: 3.0 out_task_space_weight: 0.5\n")
    pair = _zoo_paired(text, "mmoe")
    jbatch, batch = pair.batches(5)
    jpreds, jlosses = jax_main.make_eval_step(pair.jmodel, jnp.float32)(
        {"dense": pair.jstate["dense"], "tables": pair.jstate["tables"]},
        jbatch)
    _, losses = port_main.make_eval_step(pair.model)(batch)
    for k in losses:
        _close(losses[k], jlosses[k], name=k)
    # against the same loss without the indicator
    pair.model._task_tower_cfgs[1].ClearField("task_space_indicator_label")
    _, plain = port_main.make_eval_step(pair.model)(batch)
    assert float(plain["binary_cross_entropy_cvr"]) != float(
        losses["binary_cross_entropy_cvr"])


# --- the entry points -------------------------------------------------------


@pytest.fixture(scope="module")
def rest_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_rest")
    for i, n in enumerate((100, 92)):
        pq.write_table(pa.table(zoo_cols(n, seed=50 + i)),
                       os.path.join(root, f"train-{i}.parquet"))
    pq.write_table(pa.table(zoo_cols(1000, seed=60)),
                   os.path.join(root, "eval.parquet"))
    return str(root)


def _entry_config(path, model_dir, root):
    text = _rest_text(
        "wukong", 32, model_dir=model_dir, num_steps=5,
        train_path=os.path.join(root, "train-*.parquet"),
        eval_path=os.path.join(root, "eval.parquet"),
        train_extra="  save_checkpoints_steps: 3")
    with open(path, "w") as f:
        f.write(text)
    return path, text


def _eval_lines(model_dir):
    with open(os.path.join(model_dir, "train_eval_result_v2.txt")) as f:
        return [json.loads(line) for line in f]


def test_train_and_evaluate_wukong_with_vd_matches_jax(
        rest_files, tmp_path, monkeypatch, jax_engine_env):
    """5 steps of 32 over two files with a save and an eval at step 3 and
    at the end, in both packages from the JAX init; the port's
    variational dropout fed the noise of the JAX loop's step keys
    (``fold_in(key(1234), step)``)."""
    monkeypatch.setattr(jax_main, "maybe_mesh", lambda: None)
    jax_dir = str(tmp_path / "jax")
    jax_cfg, text = _entry_config(str(tmp_path / "jax.config"), jax_dir,
                                  rest_files)
    jax_main.train_and_evaluate(jax_cfg)

    _, jmodel, _, dense, tables = jax_model_and_state(text)
    init = str(tmp_path / "jax_init.pt")
    torch.save(converted_state(jmodel, dense, tables,
                               zoo_table_names("wukong")), init)
    groups = list(jmodel.group_variational_dropouts)
    calls = []

    def jax_noise(n, generator):
        step, gi = divmod(len(calls), len(groups))
        calls.append(n)
        rng = jax.random.fold_in(jax.random.key(1234), step)
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(rng, gi + 1), (n,), minval=VD_LOW,
            maxval=VD_HIGH)))

    monkeypatch.setattr(variational_dropout, "draw_noise", jax_noise)
    port_dir = str(tmp_path / "port")
    port_cfg, _ = _entry_config(str(tmp_path / "port.config"), port_dir,
                                rest_files)
    result = port_main.train_and_evaluate(port_cfg, fine_tune_checkpoint=init,
                                          device="cpu")
    assert result["step"] == 5.0
    assert len(calls) == 5 * len(groups) == 10
    ours, ref = _eval_lines(port_dir), _eval_lines(jax_dir)
    assert [r["global_step"] for r in ours] == [
        r["global_step"] for r in ref] == [3, 5]
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)


def _distinct_logits():
    """The JAX package's ``_init_state`` with variational-dropout logits
    that are all distinct."""
    orig = jax_main._init_state

    def init_state(model, cfg):
        dense, tables, opt = orig(model, cfg)
        r = np.random.default_rng(11)
        for g, p in dense["variational_dropout"].items():
            n = p["logit_p"].shape[0]
            p["logit_p"] = jnp.asarray(r.permutation(
                np.linspace(-4.0, 1.0, n)).astype(np.float32))
        return dense, tables, opt

    return init_state


@pytest.mark.parametrize("embedding_wise", [False, True])
def test_feature_selection_matches_jax(embedding_wise, tmp_path,
                                       monkeypatch, jax_engine_env):
    """The JAX tool on weights with distinct drop logits (and no
    checkpoint) against the port's tool on the same weights as a port
    checkpoint: the same ranking, keep probabilities and rewritten
    config; each keep probability is 1 - sigmoid(logit_p) of the saved
    weights."""
    text = _rest_text("wukong", model_dir=str(tmp_path / "none"))
    if embedding_wise:
        text = text.replace(
            "variational_dropout { regularization_lambda: 0.01 }",
            "variational_dropout { regularization_lambda: 0.01 "
            "embedding_wise_variational_dropout: true }")
    cfg_path = str(tmp_path / "wukong.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    monkeypatch.setattr(jax_main, "_init_state", _distinct_logits())
    ref = jax_fs.select_features(cfg_path, topk=5,
                                 output_dir=str(tmp_path / "jax_fs"))
    _, jmodel, _, dense, tables = jax_model_and_state(text)
    ckpt = str(tmp_path / "weights.pt")
    state = converted_state(jmodel, dense, tables, zoo_table_names("wukong"))
    torch.save(state, ckpt)
    got = feature_selection.select_features(
        cfg_path, ckpt, topk=5, output_dir=str(tmp_path / "port_fs"),
        device="cpu")
    assert list(got) == list(ref) and len(got) == 5
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    if not embedding_wise:
        keep = {}
        for g, names in jmodel.vd_feature_names.items():
            p = torch.sigmoid(state[f"variational_dropout.{g}.logit_p"])
            keep.update(zip(names, (1.0 - p).tolist()))
        for k in got:
            np.testing.assert_allclose(got[k], keep[k], rtol=1e-6)
    with open(str(tmp_path / "jax_fs" / "pipeline.config")) as f:
        jtext = f.read()
    with open(str(tmp_path / "port_fs" / "pipeline.config")) as f:
        ptext = f.read()
    a, b = parse_pipeline_config(ptext), parse_pipeline_config(jtext)
    assert a == b
    assert [fc.WhichOneof("feature") for fc in a.feature_configs] and len(
        a.feature_configs) == 5
    with open(str(tmp_path / "port_fs" / "feature_importance.json")) as f:
        assert list(json.load(f)) == list(got)


def test_feature_selection_without_vd_ranks_tables(tmp_path, jax_engine_env):
    """Without variational dropout the tool ranks the sparse features by
    their table's norm over its rows, the tables through
    ``extract_table`` (the packed layout's rows hold row state too)."""
    text = zoo_config_text("dlrm", model_dir=str(tmp_path / "none"))
    cfg_path = str(tmp_path / "dlrm.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    _, jmodel, _, dense, tables = jax_model_and_state(text)
    state = converted_state(jmodel, dense, tables, zoo_table_names("dlrm"))
    ckpt = str(tmp_path / "weights.pt")
    torch.save(state, ckpt)
    got = feature_selection.select_features(cfg_path, ckpt, topk=100,
                                            device="cpu")
    want = {}
    for i in range(6):
        w = state[f"embedding_group.tables.cat_{i}_emb"]
        want[f"cat_{i}"] = float(torch.linalg.vector_norm(w) / w.shape[0])
    assert list(got) == sorted(want, key=lambda k: -want[k])
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


_ABSTRACT = {"BaseModel", "RankModel", "MultiTaskRank", "MatchModel"}


def _model_classes(pkg):
    """The model classes a package's ``models/__init__.py`` registers."""
    return {n for n, v in vars(pkg).items() if isinstance(v, type)
            and issubclass(v, pkg.BaseModel) and n not in _ABSTRACT}


def test_new_classes_resolve_by_proto_name():
    import torcheasyrec_tpu.models as jax_models
    import torcheasyrec_tpu_torch.models as port_models

    for name in ("xDeepFM", "WuKong", "PEPNet", "DC2VR", "TDM"):
        assert BaseModel.create_class(name).__name__ == (
            jax_models.BaseModel.create_class(name).__name__)
    ported, ref = _model_classes(port_models), _model_classes(jax_models)
    assert len(ref) == 27 and ported <= ref
    assert len(ported) == 25
    assert ref - ported == {"SidRqvae", "SidRqkmeans"}

"""Dense optimizers and lr schedules of the port against the JAX package
(fp32, CPU).

Each dense optimizer follows the optax chain the JAX package builds from
the same proto over 3 steps on a toy parameter tree, with the schedule's
multiplier applied as the JAX train step applies it (rtol 1e-5 /
atol 1e-7). Each lr schedule gives the JAX function's value at a set of
steps (rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from google.protobuf import text_format

from torcheasyrec_tpu.optim import lr_scheduler as jax_sched
from torcheasyrec_tpu.optim import optimizer_builder as jax_builder
from torcheasyrec_tpu.protos import optimizer_pb2 as jax_pb2
from torcheasyrec_tpu_torch.optim import lr_scheduler as port_sched
from torcheasyrec_tpu_torch.optim import optimizer_builder as port_builder
from torcheasyrec_tpu_torch.protos import optimizer_pb2 as port_pb2

DENSE = [
    "sgd_optimizer { lr: 0.1 }",
    "sgd_optimizer { lr: 0.1 momentum: 0.0 weight_decay: 0.01 }",
    "sgd_optimizer { lr: 0.1 momentum: 0.8 nesterov: true }",
    "adagrad_optimizer { lr: 0.1 }",
    "adagrad_optimizer { lr: 0.1 initial_accumulator_value: 0.1 eps: 1e-7 }",
    "adam_optimizer { lr: 0.01 }",
    "adam_optimizer { lr: 0.01 beta1: 0.8 beta2: 0.9 weight_decay: 0.1 }",
    "adamw_optimizer { lr: 0.01 weight_decay: 0.1 }",
    "adadelta_optimizer { lr: 1.0 rho: 0.9 }",
    "rmsprop_optimizer { lr: 0.01 alpha: 0.9 }",
]
SCHEDULES = [
    "",
    "constant_learning_rate {}",
    "exponential_decay_learning_rate { decay_size: 10 decay_factor: 0.5 }",
    "exponential_decay_learning_rate { decay_size: 10 decay_factor: 0.5 "
    "staircase: false min_learning_rate: 0.001 warmup_learning_rate: 0.001 "
    "warmup_size: 5 }",
    "manual_step_learning_rate { schedule_sizes: [3, 4] "
    "learning_rates: [0.05, 0.001] }",
    "cosine_annealing_learning_rate { T_max: 20 min_learning_rate: 0.001 }",
    "cosine_annealing_learning_rate { T_max: 20 warmup_size: 4 "
    "warmup_learning_rate: 0.0001 by_epoch: true }",
    "cosine_annealing_warm_restarts_learning_rate { T_0: 5 }",
    "cosine_annealing_warm_restarts_learning_rate { T_0: 5 T_mult: 2 "
    "min_learning_rate: 0.002 warmup_size: 2 warmup_learning_rate: 0.001 }",
]
STEPS = [0, 1, 2, 3, 4, 5, 7, 9, 10, 14, 15, 20, 35, 100]


def _both(text, message):
    return (text_format.Parse(text, getattr(jax_pb2, message)()),
            text_format.Parse(text, getattr(port_pb2, message)()))


@pytest.mark.parametrize("sched_text", SCHEDULES)
def test_lr_schedule_matches_jax(sched_text):
    text = "adam_optimizer { lr: 0.01 } " + sched_text
    jcfg, pcfg = _both(text, "DenseOptimizer")
    js = jax_sched.create_lr_scheduler(jcfg, 0.01)
    ps = port_sched.create_lr_scheduler(pcfg, 0.01)
    assert ps["by_epoch"] == js["by_epoch"]
    got = [ps["fn"](s) for s in STEPS]
    ref = [float(js["fn"](s)) for s in STEPS]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("opt_text", DENSE)
def test_dense_optimizer_matches_optax_over_3_steps(opt_text):
    r = np.random.default_rng(0)
    text = opt_text + (" exponential_decay_learning_rate "
                       "{ decay_size: 2 decay_factor: 0.5 }")
    jcfg, pcfg = _both(text, "DenseOptimizer")
    tree = {"a": {"kernel": r.normal(size=(4, 3)).astype(np.float32),
                  "bias": r.normal(size=(3,)).astype(np.float32)},
            "b": r.normal(size=(5,)).astype(np.float32)}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, jsched = jax_builder.create_dense_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    pparams = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves]
    popt, psched = port_builder.create_dense_optimizer(pcfg, pparams)
    for step in range(3):
        grads = [r.normal(size=x.shape).astype(np.float32) for x in leaves]
        jgrads = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g) for g in grads])
        updates, jstate = tx.update(jgrads, jstate, jparams)
        mult = jsched["fn"](step, None)
        updates = jax.tree_util.tree_map(lambda u: u * mult, updates)
        jparams = optax.apply_updates(jparams, updates)
        popt.step([torch.from_numpy(g) for g in grads],
                  psched["fn"](step, None))
        for p, ref in zip(pparams, jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7)


def test_dense_optimizer_treats_a_missing_gradient_as_zero():
    _, pcfg = _both("adam_optimizer { lr: 0.1 }", "DenseOptimizer")
    params = [torch.nn.Parameter(torch.ones(3)),
              torch.nn.Parameter(torch.ones(2))]
    opt, sched = port_builder.create_dense_optimizer(pcfg, params)
    opt.step([torch.ones(3), None], sched["fn"](0))
    assert (params[0] < 1).all() and torch.equal(params[1].detach(),
                                                 torch.ones(2))


def test_dense_optimizer_state_dict_round_trip():
    _, pcfg = _both("adam_optimizer { lr: 0.1 }", "DenseOptimizer")

    def run(reload_at):
        params = [torch.nn.Parameter(torch.arange(4.0))]
        opt, _ = port_builder.create_dense_optimizer(pcfg, params)
        for step in range(4):
            if step == reload_at:
                saved = opt.state_dict()
                opt, _ = port_builder.create_dense_optimizer(pcfg, params)
                opt.load_state_dict(saved)
            opt.step([torch.full((4,), float(step + 1))])
        return params[0].detach()

    assert torch.equal(run(None), run(2))


def test_sparse_optimizer_builder_matches_jax():
    text = ("rowwise_adagrad_optimizer { lr: 0.05 } "
            "exponential_decay_learning_rate { decay_size: 10 "
            "decay_factor: 0.5 }")
    jcfg, pcfg = _both(text, "SparseOptimizer")
    jopt, jsched = jax_builder.create_sparse_optimizer(jcfg)
    popt, psched = port_builder.create_sparse_optimizer(pcfg)
    assert (popt.kind, popt.base_lr) == (jopt.kind, jopt.base_lr)
    assert popt.cfg == jopt.cfg
    assert psched["fn"](10) == pytest.approx(float(jsched["fn"](10)))


def test_unported_optimizer_options_raise():
    """Per-part optimizers and clipping are ported now
    (test_torch_port_train_options.py holds them against the JAX
    package): part optimizers need the parameters' paths, no clipping
    config gives no clipper, and an unset optimizer still raises."""
    _, pcfg = _both(
        "adam_optimizer { lr: 0.1 } part_optimizers { regex_pattern: '.*' "
        "adam_optimizer { lr: 0.2 } }", "DenseOptimizer")
    with pytest.raises(ValueError, match="paths"):
        port_builder.create_dense_optimizer(pcfg, [])
    tx, _ = port_builder.create_dense_optimizer(pcfg, [], [])
    assert [k for k, _ in tx.kinds] == ["adam_optimizer"] * 2
    assert port_builder.create_grad_clipper(None) is None
    _, empty = _both("", "SparseOptimizer")
    with pytest.raises(ValueError, match="not set"):
        port_builder.create_sparse_optimizer(empty)

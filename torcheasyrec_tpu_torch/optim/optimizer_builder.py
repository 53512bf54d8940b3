"""Dense and sparse optimizer builders.

Counterpart of torcheasyrec_tpu/optim/optimizer_builder.py. The dense
optimizers are written out by hand to the formulas of the optax chains
the JAX package builds (``_make_optax``), not taken from ``torch.optim``,
whose formulas differ in places (optax adagrad scales by
``rsqrt(acc + eps)``, optax rmsprop by ``rsqrt(nu + eps)``). An update is
``-lr * direction``, then multiplied by the schedule's multiplier, then
added to the parameter, as the JAX train step does. Per-part optimizers
and gradient clipping raise NotImplementedError.
"""

from typing import Any, Dict, List, Sequence, Tuple

import torch

from torcheasyrec_tpu_torch.optim.lr_scheduler import create_lr_scheduler
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs

_DENSE_KINDS = ("sgd_optimizer", "adagrad_optimizer", "adam_optimizer",
                "adamw_optimizer", "adadelta_optimizer", "rmsprop_optimizer")


def create_sparse_optimizer(sparse_optimizer_config
                            ) -> Tuple[SparseOptimizer, Dict]:
    """SparseOptimizer proto -> (SparseOptimizer, lr schedule dict)."""
    which = sparse_optimizer_config.WhichOneof("optimizer")
    if which is None:
        raise ValueError("train_config.sparse_optimizer is not set")
    cfg = config_to_kwargs(getattr(sparse_optimizer_config, which))
    opt = SparseOptimizer(which.replace("_optimizer", ""), cfg)
    return opt, create_lr_scheduler(sparse_optimizer_config, opt.base_lr)


class DenseOptimizer:
    """One of the six dense optimizers over a list of parameters. The
    state is one dict of tensors per parameter, under optax's names
    (``mu``/``nu`` for adam, ``trace`` for momentum, ``sum_of_squares``
    for adagrad, ``e_g``/``e_x`` for adadelta, ``nu`` for rmsprop), and a
    shared ``count`` for adam and adamw."""

    def __init__(self, kind: str, cfg: Dict[str, Any],
                 params: Sequence[torch.nn.Parameter]) -> None:
        if kind not in _DENSE_KINDS:
            raise ValueError(f"unknown dense optimizer {kind}")
        self.kind = kind
        self.cfg = dict(cfg)
        self.params = list(params)
        self.lr = float(cfg.get("lr", 0.002))
        self.count = 0
        self.state: List[Dict[str, torch.Tensor]] = [
            self._init_state(p) for p in self.params
        ]

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        c, k = self.cfg, self.kind
        zeros = lambda: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        if k == "sgd_optimizer":
            return {"trace": zeros()} if float(c.get("momentum", 0.9)) > 0 else {}
        if k == "adagrad_optimizer":
            return {"sum_of_squares": torch.full_like(
                p, float(c.get("initial_accumulator_value", 0.0)),
                dtype=torch.float32)}
        if k in ("adam_optimizer", "adamw_optimizer"):
            return {"mu": zeros(), "nu": zeros()}
        if k == "adadelta_optimizer":
            return {"e_g": zeros(), "e_x": zeros()}
        return {"nu": zeros()}  # rmsprop

    def _direction(self, g: torch.Tensor, p: torch.Tensor,
                   s: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The update before ``-lr``; moves the state ``s`` forward."""
        c, k = self.cfg, self.kind
        wd = float(c.get("weight_decay", 0.0))
        if k == "sgd_optimizer":
            if wd:
                g = g + wd * p
            mom = float(c.get("momentum", 0.9))
            if mom <= 0:
                return g
            s["trace"] = g + mom * s["trace"]
            if bool(c.get("nesterov", False)):
                return g + mom * s["trace"]
            return s["trace"]
        if k == "adagrad_optimizer":
            eps = float(c.get("eps", 1e-10))
            s["sum_of_squares"] = s["sum_of_squares"] + g * g
            acc = s["sum_of_squares"]
            return g * torch.where(acc > 0, torch.rsqrt(acc + eps),
                                   acc.new_zeros(()))
        if k in ("adam_optimizer", "adamw_optimizer"):
            b1 = float(c.get("beta1", 0.9))
            b2 = float(c.get("beta2", 0.999))
            eps = float(c.get("eps", 1e-8))
            if wd and k == "adam_optimizer":
                g = g + wd * p
            s["mu"] = b1 * s["mu"] + (1 - b1) * g
            s["nu"] = b2 * s["nu"] + (1 - b2) * g * g
            mu_hat = s["mu"] / (1 - b1 ** self.count)
            nu_hat = s["nu"] / (1 - b2 ** self.count)
            d = mu_hat / (nu_hat.sqrt() + eps)
            if k == "adamw_optimizer":
                d = d + wd * p
            return d
        if k == "adadelta_optimizer":
            rho = float(c.get("rho", 0.95))
            eps = float(c.get("eps", 1e-6))
            s["e_g"] = rho * s["e_g"] + (1 - rho) * g * g
            d = (s["e_x"] + eps).sqrt() / (s["e_g"] + eps).sqrt() * g
            s["e_x"] = rho * s["e_x"] + (1 - rho) * d * d
            return d
        decay = float(c.get("alpha", 0.99))  # rmsprop
        eps = float(c.get("eps", 1e-8))
        s["nu"] = decay * s["nu"] + (1 - decay) * g * g
        return g * torch.rsqrt(s["nu"] + eps)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr_mult: float = 1.0) -> None:
        """Update the parameters in place from ``grads`` (one per
        parameter, None where a parameter took no part in the loss, which
        counts as a zero gradient)."""
        self.count += 1
        for p, g, s in zip(self.params, grads, self.state):
            g = torch.zeros_like(p) if g is None else g.float()
            p.add_(self._direction(g, p, s) * (-self.lr * lr_mult))

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.count = int(sd["count"])
        for s, new in zip(self.state, sd["state"]):
            for k in s:
                s[k] = new[k].to(s[k].device, torch.float32)


def create_dense_optimizer(dense_optimizer_config,
                           params: Sequence[torch.nn.Parameter]
                           ) -> Tuple[DenseOptimizer, Dict]:
    """DenseOptimizer proto + parameters -> (DenseOptimizer, lr schedule
    dict whose ``fn(step, epoch)`` gives the multiplier)."""
    if len(getattr(dense_optimizer_config, "part_optimizers", [])):
        raise NotImplementedError("per-part dense optimizers are not ported")
    which = dense_optimizer_config.WhichOneof("optimizer")
    if which is None:
        raise ValueError("train_config.dense_optimizer is not set")
    cfg = config_to_kwargs(getattr(dense_optimizer_config, which))
    opt = DenseOptimizer(which, cfg, params)
    sched = create_lr_scheduler(dense_optimizer_config, opt.lr)

    def fn(step, epoch=None):
        by_epoch = sched["by_epoch"] and epoch is not None
        return sched["fn"](epoch if by_epoch else step)

    return opt, {"fn": fn, "by_epoch": sched["by_epoch"], "per_part": False}


def create_grad_clipper(grad_clipping_config):
    raise NotImplementedError("gradient clipping is not ported")

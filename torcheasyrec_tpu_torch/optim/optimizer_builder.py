"""Dense and sparse optimizer builders.

Counterpart of torcheasyrec_tpu/optim/optimizer_builder.py. The dense
optimizers are written out by hand to the formulas of the optax chains
the JAX package builds (``_make_optax``), not taken from ``torch.optim``,
whose formulas differ in places (optax adagrad scales by
``rsqrt(acc + eps)``, optax rmsprop by ``rsqrt(nu + eps)``). An update is
``-lr * direction``, then multiplied by the schedule's multiplier, then
added to the parameter, as the JAX train step does.

``part_optimizers`` give regex-selected parameters their own optimizer
(the first part whose ``regex_pattern`` fully matches a parameter's
path owns it) and, optionally, their own schedule. The regex is matched
against the JAX package's ``/``-joined parameter paths
(``utils/convert.dense_param_paths``), so one config selects the same
parameters in both packages. ``create_grad_clipper`` gives the global
norm or value clipping the optimizer applies to the dense gradients
before its update, as the JAX package's ``optax.chain(clipper, tx)``.
"""

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
    """The dense optimizers over a list of parameters: ``kinds[0]`` (the
    main optimizer, with its config) and one more per part optimizer;
    ``owner[i]`` says which one updates parameter i (all the main one
    without parts). The state is one dict of tensors per parameter,
    under optax's names (``mu``/``nu`` for adam, ``trace`` for momentum,
    ``sum_of_squares`` for adagrad, ``e_g``/``e_x`` for adadelta, ``nu``
    for rmsprop), and one ``count`` of updates, a 0-d tensor on the
    parameters' device: every part is updated at every step, so the
    counts of the JAX package's masked adams agree. ``clipper``
    (``create_grad_clipper``) transforms the whole list of gradients
    first."""

    def __init__(self, kind: str, cfg: Dict[str, Any],
                 params: Sequence[torch.nn.Parameter],
                 parts: Sequence[Tuple[str, Dict[str, Any]]] = (),
                 owner: Optional[Sequence[int]] = None,
                 clipper: Optional[Callable] = None) -> None:
        self.kinds = [(kind, dict(cfg))] + [(k, dict(c)) for k, c in parts]
        for k, _ in self.kinds:
            if k not in _DENSE_KINDS:
                raise ValueError(f"unknown dense optimizer {k}")
        self.kind, self.cfg = self.kinds[0]
        self.params = list(params)
        self.owner = list(owner) if owner is not None else [0] * len(
            self.params)
        self.lr = float(cfg.get("lr", 0.002))
        self.clipper = clipper
        self._count = torch.zeros(
            (), device=self.params[0].device if self.params else None)
        self.state: List[Dict[str, torch.Tensor]] = [
            self._init_state(p, *self.kinds[o])
            for p, o in zip(self.params, self.owner)
        ]

    @staticmethod
    def _init_state(p: torch.Tensor, k: str,
                    c: Dict[str, Any]) -> Dict[str, torch.Tensor]:
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

    @property
    def count(self) -> int:
        return int(self._count)

    @staticmethod
    def _direction(g: torch.Tensor, p: torch.Tensor,
                   s: Dict[str, torch.Tensor], k: str, c: Dict[str, Any],
                   count: torch.Tensor) -> torch.Tensor:
        """The update before ``-lr`` at update number ``count``; moves
        the state ``s`` forward."""
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
            mu_hat = s["mu"] / (1 - b1 ** count)
            nu_hat = s["nu"] / (1 - b2 ** count)
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
    def step(self, grads: Sequence[Optional[torch.Tensor]],
             lr_mult=1.0, gate: Optional[torch.Tensor] = None,
             keep: Optional[torch.Tensor] = None) -> None:
        """Update the parameters in place from ``grads`` (one per
        parameter, None where a parameter took no part in the loss, which
        counts as a zero gradient). ``lr_mult`` is the schedule's
        multiplier, or a list of one per parameter (per-part schedules);
        ``gate`` (a 0-d tensor, the grad scaler's) multiplies the update
        and not the state, which moves forward whatever its value, unless
        ``keep`` (a 0-d bool tensor) is false: then the state and the
        count keep their values."""
        count = self._count + 1
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        if self.clipper is not None:
            grads = self.clipper(grads)
        mults = (lr_mult if isinstance(lr_mult, (list, tuple))
                 else [lr_mult] * len(self.params))
        for p, g, s, o, m in zip(self.params, grads, self.state, self.owner,
                                 mults):
            k, c = self.kinds[o]
            new = dict(s)
            u = self._direction(g, p, new, k, c, count) * (
                -float(c.get("lr", 0.002)) * m)
            p.add_(u if gate is None else u * gate)
            for name in s:
                s[name] = (new[name] if keep is None
                           else torch.where(keep, new[name], s[name]))
        self._count = count if keep is None else torch.where(
            keep, count, self._count)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._count = torch.tensor(float(sd["count"]),
                                   device=self._count.device)
        for s, new in zip(self.state, sd["state"]):
            for k in s:
                s[k] = new[k].to(s[k].device, torch.float32)


def _owner_index(path: str, part_patterns) -> int:
    """0 = the main optimizer; i + 1 = the first part whose regex fully
    matches ``path``."""
    for i, pat in enumerate(part_patterns):
        if pat.fullmatch(path):
            return i + 1
    return 0


def create_dense_optimizer(dense_optimizer_config,
                           params: Sequence[torch.nn.Parameter],
                           paths: Optional[Sequence[str]] = None,
                           grad_clipping=None
                           ) -> Tuple[DenseOptimizer, Dict]:
    """DenseOptimizer proto + parameters -> (DenseOptimizer, lr schedule
    dict whose ``fn(step, epoch)`` gives the multiplier: one number, or
    with ``per_part`` (a part with a schedule of its own) a list of one
    per parameter). ``paths`` are the parameters' JAX-style paths, which
    ``part_optimizers`` need. ``grad_clipping`` is the train config's
    GradClipping, or None."""
    which = dense_optimizer_config.WhichOneof("optimizer")
    if which is None:
        raise ValueError("train_config.dense_optimizer is not set")
    cfg = config_to_kwargs(getattr(dense_optimizer_config, which))
    base_lr = float(cfg.get("lr", 0.002))
    main_sched = create_lr_scheduler(dense_optimizer_config, base_lr)
    part_cfgs = list(getattr(dense_optimizer_config, "part_optimizers", []))
    if part_cfgs and paths is None:
        raise ValueError("part_optimizers need the parameters' paths")
    patterns = [re.compile(pc.regex_pattern) for pc in part_cfgs]
    owner = [_owner_index(p, patterns) for p in paths or ()] or None
    parts, scheds = [], [main_sched]
    for pc in part_cfgs:
        pwhich = pc.WhichOneof("optimizer")
        pcfg = config_to_kwargs(getattr(pc, pwhich))
        parts.append((pwhich, pcfg))
        # a part's own schedule, else the main one against the part's lr
        part_base = float(pcfg.get("lr", 0.002))
        holder = (pc if pc.WhichOneof("learning_rate") is not None
                  else dense_optimizer_config)
        scheds.append(create_lr_scheduler(holder, part_base))
    opt = DenseOptimizer(which, cfg, params, parts, owner,
                         create_grad_clipper(grad_clipping))
    per_part = any(pc.WhichOneof("learning_rate") is not None
                   for pc in part_cfgs)

    def mult(s, step, epoch):
        # by_epoch schedules step once per epoch
        return s["fn"](epoch if s["by_epoch"] and epoch is not None
                       else step)

    def fn(step, epoch=None):
        if not per_part:
            return mult(main_sched, step, epoch)
        vals = [mult(s, step, epoch) for s in scheds]
        return [vals[o] for o in opt.owner]

    return opt, {"fn": fn, "by_epoch": main_sched["by_epoch"],
                 "per_part": per_part}


def create_grad_clipper(grad_clipping_config
                        ) -> Optional[Callable[[List[torch.Tensor]],
                                               List[torch.Tensor]]]:
    """GradClipping proto -> a function of the list of dense gradients,
    or None: ``norm`` scales all of them by ``max_gradient / global
    norm`` when the global norm exceeds ``max_gradient`` (optax
    ``clip_by_global_norm``), ``value`` clips each element to
    [-max_gradient, max_gradient] (optax ``clip``)."""
    if grad_clipping_config is None:
        return None
    ct = grad_clipping_config.clipping_type
    mg = float(grad_clipping_config.max_gradient)
    if ct == "norm":
        def clip_norm(grads):
            norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
            keep = norm < mg
            return [torch.where(keep, g, g / norm * mg) for g in grads]
        return clip_norm
    if ct == "value":
        return lambda grads: [g.clamp(-mg, mg) for g in grads]
    return None

"""LR schedules as pure functions of the step (or epoch).

Counterpart of torcheasyrec_tpu/optim/lr_scheduler.py: constant,
exponential_decay, manual_step, cosine_annealing and
cosine_annealing_warm_restarts, each with by_epoch stepping and warm-up.
A schedule maps a step count (a Python number; the train step keeps its
counter on the host) to a multiplier on the base lr, applied both to the
dense optimizer's updates and to the fused sparse updates.
"""

import math
from typing import Any, Callable, Dict


def _warmup_wrap(fn: Callable[[float], float], warmup_lr_ratio: float,
                 warmup_size: int) -> Callable[[float], float]:
    if warmup_size <= 0:
        return fn

    def wrapped(step):
        step = float(step)
        if step >= warmup_size:
            return fn(step)
        frac = min(max(step / warmup_size, 0.0), 1.0)
        return warmup_lr_ratio + (1.0 - warmup_lr_ratio) * frac

    return wrapped


def create_lr_scheduler(lr_oneof_holder: Any, base_lr: float) -> Dict[str, Any]:
    """Build from the learning_rate oneof of an optimizer proto.

    Returns dict(fn=step -> multiplier, by_epoch=bool)."""
    which = lr_oneof_holder.WhichOneof("learning_rate")
    if which is None or which == "constant_learning_rate":
        return {"fn": lambda step: 1.0, "by_epoch": False}
    cfg = getattr(lr_oneof_holder, which)
    by_epoch = bool(getattr(cfg, "by_epoch", False))

    def ratio(lr: float, default: float = 0.0) -> float:
        return float(lr) / base_lr if base_lr else default

    if which == "exponential_decay_learning_rate":
        decay_size = max(int(cfg.decay_size), 1)
        factor = float(cfg.decay_factor)
        staircase = bool(cfg.staircase)
        min_ratio = ratio(cfg.min_learning_rate)
        warm = int(cfg.warmup_size)

        def fn(step):
            # decay starts from 0 after warm-up ends
            t = max(float(step) - warm, 0.0) / decay_size
            if staircase:
                t = math.floor(t)
            return max(factor ** t, min_ratio)

        return {"fn": _warmup_wrap(fn, ratio(cfg.warmup_learning_rate), warm),
                "by_epoch": by_epoch}

    if which == "manual_step_learning_rate":
        sizes = list(cfg.schedule_sizes)
        boundaries = [sum(sizes[: i + 1]) for i in range(len(sizes))]
        ratios = [1.0] + [ratio(lr, 1.0) for lr in cfg.learning_rates]

        def fn(step):
            idx = sum(float(step) >= b for b in boundaries)
            return ratios[min(idx, len(ratios) - 1)]

        return {"fn": fn, "by_epoch": by_epoch}

    if which == "cosine_annealing_learning_rate":
        t_max = max(int(cfg.T_max), 1)
        min_ratio = ratio(cfg.min_learning_rate)
        warm = int(cfg.warmup_size)

        def fn(step):
            t = min(max(float(step) - warm, 0.0), t_max)
            return min_ratio + (1 - min_ratio) * 0.5 * (
                1 + math.cos(math.pi * t / t_max))

        return {"fn": _warmup_wrap(fn, ratio(cfg.warmup_learning_rate), warm),
                "by_epoch": by_epoch}

    if which == "cosine_annealing_warm_restarts_learning_rate":
        t0 = max(int(cfg.T_0), 1)
        t_mult = max(int(cfg.T_mult), 1)
        min_ratio = ratio(cfg.min_learning_rate)

        def fn(step):
            t = float(step)
            if t_mult == 1:
                t_cur, t_i = math.fmod(t, t0), float(t0)
            else:
                # the number n of completed restarts satisfies
                # t0 * (t_mult^n - 1) / (t_mult - 1) <= t
                n = math.floor(
                    math.log1p(t / t0 * (t_mult - 1)) / math.log(t_mult))
                t_cur = t - t0 * (t_mult ** n - 1) / (t_mult - 1)
                t_i = t0 * t_mult ** n
            return min_ratio + (1 - min_ratio) * 0.5 * (
                1 + math.cos(math.pi * t_cur / t_i))

        return {
            "fn": _warmup_wrap(fn, ratio(cfg.warmup_learning_rate),
                               int(cfg.warmup_size)),
            "by_epoch": by_epoch,
        }

    raise ValueError(f"unknown lr schedule {which}")

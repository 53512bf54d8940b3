"""Pareto-efficient multi-task loss weights.

Counterpart of torcheasyrec_tpu/losses/pe_mtl_loss.py: weights on the
simplex that minimise ||sum_i w_i l_i||^2 over the losses scaled by
their largest magnitude, each held at or above its floor
(``pareto_min_loss_weight``), by 20 projected-gradient iterations (step
0.15) from the uniform weights over the losses' sorted names; a step that
puts every weight at 0 falls back to the uniform weights. The weights
are then scaled to a mean of 1 and detached. All on the losses' device.
"""

from typing import Dict, Optional

import torch


def pareto_loss_weights(losses: Dict[str, torch.Tensor],
                        min_weights: Optional[Dict[str, float]] = None,
                        iters: int = 20) -> Dict[str, torch.Tensor]:
    names = sorted(losses)
    l = torch.stack([losses[n].detach().float() for n in names])
    k = len(names)
    floors = l.new_tensor([float((min_weights or {}).get(n, 0.0))
                           for n in names])
    uniform = torch.full_like(l, 1.0 / k)
    l = l / (l.abs().max() + 1e-12)
    w = uniform
    for _ in range(iters):
        w = torch.maximum(w - 0.15 * (2.0 * torch.dot(w, l) * l), floors)
        total = w.sum()
        w = torch.where(total > 1e-12, w / total.clamp(min=1e-12), uniform)
    w = w * k
    return {n: w[i] for i, n in enumerate(names)}


def apply_pareto_weights(losses: Dict[str, torch.Tensor],
                         min_weights: Optional[Dict[str, float]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Each loss times its detached Pareto weight."""
    weights = pareto_loss_weights(losses, min_weights)
    return {n: weights[n] * v for n, v in losses.items()}

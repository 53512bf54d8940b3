"""Fused sparse (embedding) optimizers as row-sparse updates.

Counterpart of torcheasyrec_tpu/parallel/sparse_optim.py. Each optimizer
is a function over the touched rows only: given deduplicated row ids and
summed row gradients it updates those rows of the table and of its
state in place, so a step costs O(touched rows), whatever the table's
size. All math runs in fp32.

``apply_rows`` is the pure row-level function (old weight rows, old
state rows, gradients) -> (new rows, new state rows, new scalar state);
``apply`` wraps it with the gather and the in-place ``index_copy_`` for
``[rows, dim]`` tables. Ported kinds: sgd, adagrad, rowwise_adagrad and
adam. lars_sgd, lamb, partial_rowwise_lamb, partial_rowwise_adam,
adadelta and rmsprop raise NotImplementedError. Column segments of
merged tables and column-sharded reductions are not ported.
"""

from typing import Any, Dict, List, Tuple

import torch

Params = Dict[str, Any]

PORTED_KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")
_QUEUED_KINDS = ("lars_sgd", "lamb", "partial_rowwise_lamb",
                 "partial_rowwise_adam", "adadelta", "rmsprop")


class SparseOptimizer:
    """Stateless descriptor; the state lives in plain dicts of tensors."""

    def __init__(self, kind: str, cfg: Dict[str, Any]) -> None:
        if kind in _QUEUED_KINDS:
            raise NotImplementedError(
                f"sparse optimizer {kind} is not ported; ported kinds: "
                f"{PORTED_KINDS}"
            )
        if kind not in PORTED_KINDS:
            raise ValueError(f"unknown sparse optimizer {kind}")
        self.kind = kind
        self.cfg = dict(cfg)
        self.base_lr = float(cfg.get("lr", 0.002))

    # -- state -------------------------------------------------------------

    def row_state_widths(self, dim: int) -> List[Tuple[str, int]]:
        """Per-row state columns as (name, width)."""
        return {
            "sgd": [],
            "adagrad": [("acc", dim)],
            "rowwise_adagrad": [("acc", 1)],
            "adam": [("m", dim), ("v", dim)],
        }[self.kind]

    def row_state_init(self) -> Dict[str, float]:
        """Fill value per row-state column at init."""
        if self.kind in ("adagrad", "rowwise_adagrad"):
            return {"acc": float(
                self.cfg.get("initial_accumulator_value", 0.0))}
        return {}

    def scalar_state_init(self, device=None) -> Params:
        """Non-row state (shared scalars): the adam step count."""
        if self.kind == "adam":
            return {"step": torch.zeros((), dtype=torch.int32, device=device)}
        return {}

    def init_state(self, rows: int, dim: int, device=None) -> Params:
        out: Params = dict(self.scalar_state_init(device))
        fills = self.row_state_init()
        for name, width in self.row_state_widths(dim):
            out[name] = torch.full((rows, width), fills.get(name, 0.0),
                                   dtype=torch.float32, device=device)
        return out

    # -- row math ----------------------------------------------------------

    def apply_rows(
        self,
        w_rows: torch.Tensor,  # [K, dim] old weights
        srows: Params,         # {name: [K, width]} old row state
        grads: torch.Tensor,   # [K, dim] fp32 (deduplicated row grad sums)
        lr,                    # scalar (schedule-scaled), float or tensor
        scalar_state: Params,  # {"step": ...} for adam
    ) -> Tuple[torch.Tensor, Params, Params]:
        """Pure row-level update: (new_rows, new_srows, new_scalar_state).
        No table access."""
        c = self.cfg
        k = self.kind
        if c.get("gradient_clipping", False):
            mg = float(c.get("max_gradient", 1.0))
            grads = grads.clamp(-mg, mg)
        w_rows = w_rows.float()
        wd = float(c.get("weight_decay", 0.0))
        if wd and k == "adam":
            grads = grads + wd * w_rows

        if k == "sgd":
            return w_rows - lr * grads, {}, {}

        if k == "adagrad":
            eps = float(c.get("eps", 1e-10))
            acc = srows["acc"] + grads * grads
            return w_rows - lr * grads / (acc.sqrt() + eps), {"acc": acc}, {}

        if k == "rowwise_adagrad":
            eps = float(c.get("eps", 1e-10))
            acc = srows["acc"] + (grads * grads).mean(dim=-1, keepdim=True)
            return w_rows - lr * grads / (acc.sqrt() + eps), {"acc": acc}, {}

        # adam
        b1 = float(c.get("beta1", 0.9))
        b2 = float(c.get("beta2", 0.999))
        eps = float(c.get("eps", 1e-8))
        step = scalar_state["step"] + 1
        m = b1 * srows["m"] + (1 - b1) * grads
        v = b2 * srows["v"] + (1 - b2) * grads * grads
        t = step.float()
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        new_rows = w_rows - lr * mh / (vh.sqrt() + eps)
        return new_rows, {"m": m, "v": v}, {"step": step}

    # -- update ([rows, dim] tables) -----------------------------------------

    @torch.no_grad()
    def apply(
        self,
        weight: torch.Tensor,  # [rows, dim], updated in place
        state: Params,         # updated in place (scalars replaced)
        uids: torch.Tensor,    # [K] unique row ids; < 0 or >= rows dropped
        grads: torch.Tensor,   # [K, dim] fp32 (deduplicated row sums)
        lr,
    ) -> Tuple[torch.Tensor, Params]:
        """Update the rows ``uids`` of ``weight`` and of the row state in
        place; every other row keeps its bits. Ids outside [0, rows) are
        dropped here (the JAX package drops them in its scatter)."""
        rows, dim = weight.shape
        valid = (uids >= 0) & (uids < rows)
        uids = uids[valid].long()
        grads = grads[valid].float()
        widths = self.row_state_widths(dim)
        names = {n for n, _ in widths}
        srows = {n: state[n][uids] for n in names}
        scalar = {k: v for k, v in state.items() if k not in names}
        new_rows, new_srows, new_scalar = self.apply_rows(
            weight[uids], srows, grads, lr, scalar)
        weight.index_copy_(0, uids, new_rows.to(weight.dtype))
        for n in names:
            state[n].index_copy_(0, uids, new_srows[n])
        state.update(new_scalar)
        return weight, state

"""Fused sparse (embedding) optimizers as row-sparse updates.

Counterpart of torcheasyrec_tpu/parallel/sparse_optim.py. Each optimizer
is a function over the touched rows only: given deduplicated row ids and
summed row gradients it updates those rows of the table and of its
state in place, so a step costs O(touched rows), whatever the table's
size. All math runs in fp32.

``apply_rows`` is the pure row-level function (old weight rows, old
state rows, gradients) -> (new rows, new state rows, new scalar state);
``apply`` wraps it with the gather and the in-place ``index_copy_`` for
``[rows, dim]`` tables. Every kind of the sparse optimizer oneof:
sgd, adagrad, rowwise_adagrad, adam, partial_rowwise_adam, lamb,
partial_rowwise_lamb, lars_sgd, adadelta and rmsprop. The row-wise
reductions (rowwise adagrad's and the partial kinds' mean of g^2, lamb's
and lars's norms) run over the ``dim`` weight lanes of a row only, never
over its state lanes. Under a column-wise layout a rank holds some of a
row's columns: ``dim_reduce`` (an ``all_reduce`` over the ranks) sums
those reductions over the ranks and ``full_dim`` is the whole row's
width, as the JAX package's ``dim_psum_axis`` and ``full_dim``.

Column segments (``col_segments``, the widths of the logical tables that
the engine's co-keyed merge fused into one row): the row-wise reductions
then run per segment, each over its own columns, and the row-wise state
keeps one column per segment, so that every logical table's optimizer
math is the one it has unmerged (the JAX package's ``_dim_sum`` with
``segs``). A merged table is never column-wise: segments and
``dim_reduce`` never meet.
"""

from typing import Any, Dict, List, Tuple

import torch

Params = Dict[str, Any]

PORTED_KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam",
                "partial_rowwise_adam", "lamb", "partial_rowwise_lamb",
                "lars_sgd", "adadelta", "rmsprop")
# kinds that keep a step count beside the row state
_STEP_KINDS = ("adam", "partial_rowwise_adam", "lamb", "partial_rowwise_lamb")
# kinds whose weight decay is added to the gradient
_DECAY_KINDS = ("adam", "lamb", "partial_rowwise_lamb", "partial_rowwise_adam",
                "lars_sgd", "adadelta", "rmsprop")


def _segmented(segs) -> bool:
    return segs is not None and len(segs) > 1


def _per_segment(x: torch.Tensor, segs, fn) -> torch.Tensor:
    """[K, n_seg]: ``fn`` of each segment's columns of ``x`` [K, dim]."""
    out, off = [], 0
    for w in segs:
        out.append(fn(x[:, off:off + w]))
        off += w
    return torch.cat(out, dim=1)


def _row_norm(x: torch.Tensor, dim_reduce=None, segs=None) -> torch.Tensor:
    """[K, 1] L2 norm of each row (of the whole row, under
    ``dim_reduce``); [K, n_seg] of each segment's columns."""
    if _segmented(segs):
        return _per_segment(
            x, segs, lambda c: (c * c).sum(dim=-1, keepdim=True).sqrt())
    s = (x * x).sum(dim=-1, keepdim=True)
    return (s if dim_reduce is None else dim_reduce(s)).sqrt()


def _row_mean(x: torch.Tensor, dim_reduce=None, full_dim=None,
              segs=None) -> torch.Tensor:
    """[K, 1] mean of each row (of the whole row of ``full_dim``
    columns, under ``dim_reduce``); [K, n_seg] of each segment's
    columns."""
    if _segmented(segs):
        return _per_segment(x, segs, lambda c: c.mean(dim=-1, keepdim=True))
    if dim_reduce is None:
        return x.mean(dim=-1, keepdim=True)
    return dim_reduce(x.sum(dim=-1, keepdim=True)) / float(full_dim)


def _seg_expand(s: torch.Tensor, segs) -> torch.Tensor:
    """[K, n_seg] per-segment values -> [K, dim], each repeated over its
    segment's columns (unchanged when unsegmented)."""
    if not _segmented(segs):
        return s
    return torch.repeat_interleave(
        s, torch.tensor(segs, device=s.device), dim=1,
        output_size=sum(segs))


class SparseOptimizer:
    """Stateless descriptor; the state lives in plain dicts of tensors."""

    def __init__(self, kind: str, cfg: Dict[str, Any]) -> None:
        if kind not in PORTED_KINDS:
            raise ValueError(f"unknown sparse optimizer {kind}")
        self.kind = kind
        self.cfg = dict(cfg)
        self.base_lr = float(cfg.get("lr", 0.002))

    # -- state -------------------------------------------------------------

    def row_state_widths(self, dim: int, col_segments=None
                         ) -> List[Tuple[str, int]]:
        """Per-row state columns as (name, width); the order is the in-row
        layout of packed tables. With ``col_segments`` the row-wise state
        keeps one column per segment."""
        ns = len(col_segments) if col_segments else 1
        return {
            "sgd": [],
            "adagrad": [("acc", dim)],
            "rowwise_adagrad": [("acc", ns)],
            "adam": [("m", dim), ("v", dim)],
            "partial_rowwise_adam": [("m", dim), ("v", ns)],
            "lamb": [("m", dim), ("v", dim)],
            "partial_rowwise_lamb": [("m", dim), ("v", ns)],
            "lars_sgd": [("mom", dim)],
            "adadelta": [("acc", dim), ("delta_acc", dim)],
            "rmsprop": [("sq", dim)],
        }[self.kind]

    def row_state_init(self) -> Dict[str, float]:
        """Fill value per row-state column at init."""
        if self.kind in ("adagrad", "rowwise_adagrad"):
            return {"acc": float(
                self.cfg.get("initial_accumulator_value", 0.0))}
        return {}

    def scalar_state_init(self, device=None) -> Params:
        """Non-row state (shared scalars): the adam and lamb step count."""
        if self.kind in _STEP_KINDS:
            return {"step": torch.zeros((), dtype=torch.int32, device=device)}
        return {}

    def init_state(self, rows: int, dim: int, device=None,
                   col_segments=None) -> Params:
        out: Params = dict(self.scalar_state_init(device))
        fills = self.row_state_init()
        for name, width in self.row_state_widths(dim, col_segments):
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
        scalar_state: Params,  # {"step": ...} for the adam and lamb kinds
        dim_reduce=None,       # column-wise: sum over the ranks
        full_dim=None,         # column-wise: the whole row's width
        col_segments=None,     # merged tables: the segments' widths
    ) -> Tuple[torch.Tensor, Params, Params]:
        """Pure row-level update: (new_rows, new_srows, new_scalar_state).
        No table access."""
        segs = col_segments
        if _segmented(segs) and dim_reduce is not None:
            raise ValueError(
                "merged (column-segmented) tables cannot be column-wise: "
                "per-segment reductions do not compose with a reduction "
                "over the ranks")
        c = self.cfg
        k = self.kind
        if c.get("gradient_clipping", False):
            mg = float(c.get("max_gradient", 1.0))
            grads = grads.clamp(-mg, mg)
        w_rows = w_rows.float()
        wd = float(c.get("weight_decay", 0.0))
        if wd and k in _DECAY_KINDS:
            grads = grads + wd * w_rows

        if k == "sgd":
            return w_rows - lr * grads, {}, {}

        if k == "adagrad":
            eps = float(c.get("eps", 1e-10))
            acc = srows["acc"] + grads * grads
            return w_rows - lr * grads / (acc.sqrt() + eps), {"acc": acc}, {}

        if k == "rowwise_adagrad":
            eps = float(c.get("eps", 1e-10))
            acc = srows["acc"] + _row_mean(grads * grads, dim_reduce,
                                           full_dim, segs)
            return (w_rows - lr * grads / (_seg_expand(acc, segs).sqrt()
                                           + eps), {"acc": acc}, {})

        if k in _STEP_KINDS:
            lamb = k in ("lamb", "partial_rowwise_lamb")
            b1 = float(c.get("beta1", 0.9))
            b2 = float(c.get("beta2", 0.999))
            eps = float(c.get("eps", 1e-6 if lamb else 1e-8))
            step = scalar_state["step"] + 1
            m = b1 * srows["m"] + (1 - b1) * grads
            g2 = grads * grads
            if k.startswith("partial_rowwise"):
                g2 = _row_mean(g2, dim_reduce, full_dim, segs)
            v = b2 * srows["v"] + (1 - b2) * g2
            t = step.float()
            mh = m / (1 - b1 ** t)
            vh = v / (1 - b2 ** t)
            if k.startswith("partial_rowwise"):
                vh = _seg_expand(vh, segs)
            upd = mh / (vh.sqrt() + eps)
            if lamb:
                w_norm = _row_norm(w_rows, dim_reduce, segs)
                u_norm = _row_norm(upd, dim_reduce, segs)
                trust = torch.where((w_norm > 0) & (u_norm > 0),
                                    w_norm / (u_norm + 1e-12),
                                    w_norm.new_ones(()))
                upd = _seg_expand(trust, segs) * upd
            return w_rows - lr * upd, {"m": m, "v": v}, {"step": step}

        if k == "lars_sgd":
            momentum = float(c.get("momentum", 0.9))
            eta = float(c.get("eta", 0.001))
            w_norm = _row_norm(w_rows, dim_reduce, segs)
            g_norm = _row_norm(grads, dim_reduce, segs)
            local_lr = _seg_expand(torch.where(
                (w_norm > 0) & (g_norm > 0), eta * w_norm / (g_norm + 1e-12),
                w_norm.new_ones(())), segs)
            mom = momentum * srows["mom"] + local_lr * lr * grads
            return w_rows - mom, {"mom": mom}, {}

        if k == "adadelta":
            rho = float(c.get("rho", 0.95))
            eps = float(c.get("eps", 1e-6))
            acc = rho * srows["acc"] + (1 - rho) * grads * grads
            delta = (srows["delta_acc"] + eps).sqrt() / (acc + eps).sqrt() * grads
            dacc = rho * srows["delta_acc"] + (1 - rho) * delta * delta
            return w_rows - lr * delta, {"acc": acc, "delta_acc": dacc}, {}

        # rmsprop
        alpha = float(c.get("alpha", 0.99))
        eps = float(c.get("eps", 1e-8))
        sq = alpha * srows["sq"] + (1 - alpha) * grads * grads
        return w_rows - lr * grads / (sq.sqrt() + eps), {"sq": sq}, {}

    # -- update ([rows, dim] tables) -----------------------------------------

    @torch.no_grad()
    def apply(
        self,
        weight: torch.Tensor,  # [rows, dim], updated in place
        state: Params,         # updated in place (scalars replaced)
        uids: torch.Tensor,    # [K] unique row ids; < 0 or >= rows dropped
        grads: torch.Tensor,   # [K, dim] fp32 (deduplicated row sums)
        lr,
        dim_reduce=None,
        full_dim=None,
        col_segments=None,
    ) -> Tuple[torch.Tensor, Params]:
        """Update the rows ``uids`` of ``weight`` and of the row state in
        place; every other row keeps its bits. Ids outside [0, rows) are
        dropped here (the JAX package drops them in its scatter)."""
        rows, dim = weight.shape
        valid = (uids >= 0) & (uids < rows)
        uids = uids[valid].long()
        grads = grads[valid].float()
        widths = self.row_state_widths(dim, col_segments)
        names = {n for n, _ in widths}
        srows = {n: state[n][uids] for n in names}
        scalar = {k: v for k, v in state.items() if k not in names}
        new_rows, new_srows, new_scalar = self.apply_rows(
            weight[uids], srows, grads, lr, scalar, dim_reduce, full_dim,
            col_segments)
        weight.index_copy_(0, uids, new_rows.to(weight.dtype))
        for n in names:
            state[n].index_copy_(0, uids, new_srows[n])
        state.update(new_scalar)
        return weight, state

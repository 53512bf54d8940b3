"""Loss functions.

Counterpart of torcheasyrec_tpu/losses/__init__.py. All return
per-sample losses [B], in fp32; the reduction (with sample weights)
happens in the model base. ``jrc_loss`` also reads each sample's
session id, which the models pass as ``session_ids``, and over several
ranks the model's ``shard``.
"""

from typing import Any, Dict

import torch
import torch.nn.functional as F

from torcheasyrec_tpu_torch.parallel.mesh import (
    all_gather_with_grad,
    gather_rows,
    row_offset,
)


def binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """BCE with logits, per element, in fp32:
    max(x, 0) - x y + log1p(exp(-|x|))."""
    labels = labels.float()
    if label_smoothing > 0:
        labels = labels * (1 - label_smoothing) + 0.5 * label_smoothing
    logits = logits.float()
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Multi-class CE; labels int [B] or probabilities [B, C]."""
    logits = logits.float()
    n_class = logits.shape[-1]
    if labels.dim() == logits.dim() - 1:
        onehot = F.one_hot(labels.long(), n_class).float()
    else:
        onehot = labels.float()
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n_class
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def l2_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    d = preds.float() - labels.float()
    return 0.5 * d * d


def binary_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                      gamma: float = 2.0, alpha: float = 0.5) -> torch.Tensor:
    """Focal loss: alpha_t (1 - p_t)^gamma BCE."""
    labels = labels.float()
    p = torch.sigmoid(logits.float())
    ce = binary_cross_entropy(logits, labels)
    p_t = p * labels + (1 - p) * (1 - labels)
    alpha_t = alpha * labels + (1 - alpha) * (1 - labels)
    return alpha_t * (1 - p_t) ** gamma * ce


def jrc_loss(logits: torch.Tensor, labels: torch.Tensor,
             session_ids: torch.Tensor, alpha: float = 0.5,
             shard=None) -> torch.Tensor:
    """Joint Ranking and Calibration loss on two-class logits [B, 2]:
    alpha times the two-class CE plus (1 - alpha) times the session-wise
    listwise term. In the listwise term each sample competes, per class,
    with itself and with the samples of the same session and of the
    other label; it is the log-softmax of the class's logit over that
    set, read at the sample. Builds [B, B] fp32 tensors.

    Over several ranks (``shard``, a ``parallel/mesh.ShardContext``) the
    competitors are the global batch's: each rank builds its rows
    [B_local, B_global] against every rank's logits (gathered with their
    gradients), labels and session ids, its own samples from its first
    global row on, so that its per-sample losses are the global batch's
    at its rows."""
    logits = logits.float()
    labels_i = labels.long()
    ce = softmax_cross_entropy(logits, labels_i)
    b = logits.shape[0]
    cols = all_gather_with_grad(logits, shard)
    col_labels = gather_rows(labels_i, shard).float()
    same_sess = session_ids[:, None] == gather_rows(session_ids,
                                                    shard)[None, :]
    off = row_offset(b, shard)
    own = (torch.arange(cols.shape[0], device=logits.device)[None, :]
           == torch.arange(off, off + b, device=logits.device)[:, None])
    y = labels_i.float()

    def listwise(col_logits, indicator, other_class):
        allow = same_sess & (own | (other_class[None, :] > 0))
        masked = torch.where(allow, col_logits[None, :],
                             col_logits.new_full((), float("-inf")))
        diag = torch.log_softmax(masked, dim=-1).diagonal(off)
        return -(diag * indicator)

    ge = (listwise(cols[:, 1], y, 1.0 - col_labels)
          + listwise(cols[:, 0], 1.0 - y, col_labels))
    return alpha * ce + (1 - alpha) * ge


def create_loss_fn(loss_config) -> Dict[str, Any]:
    """LossConfig proto -> {name, num_class, fn(logits or preds, labels,
    **kw)}; ``jrc_loss`` also names its ``session_name`` feature, whose
    values the model passes to ``fn`` as ``session_ids``, with the
    model's ``shard`` over several ranks."""
    which = loss_config.WhichOneof("loss")
    cfg = getattr(loss_config, which)
    if which == "binary_cross_entropy":
        ls = cfg.label_smoothing
        return {"name": which, "num_class": 1,
                "fn": lambda x, y, **kw: binary_cross_entropy(x, y, ls)}
    if which == "softmax_cross_entropy":
        ls = cfg.label_smoothing
        return {"name": which, "num_class": 2,
                "fn": lambda x, y, **kw: softmax_cross_entropy(x, y, ls)}
    if which == "l2_loss":
        return {"name": which, "num_class": 1,
                "fn": lambda x, y, **kw: l2_loss(x, y)}
    if which == "binary_focal_loss":
        g, a = cfg.gamma, cfg.alpha
        return {"name": which, "num_class": 1,
                "fn": lambda x, y, **kw: binary_focal_loss(x, y, g, a)}
    if which == "jrc_loss":
        a = cfg.alpha
        return {"name": which, "num_class": 2,
                "session_name": cfg.session_name,
                "fn": lambda x, y, session_ids, shard=None, **kw: jrc_loss(
                    x, y, session_ids, a, shard)}
    raise ValueError(f"unsupported loss {which}")

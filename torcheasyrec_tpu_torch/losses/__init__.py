"""Loss functions.

Counterpart of torcheasyrec_tpu/losses/__init__.py. All return
per-sample losses [B]; the reduction (with sample weights) happens in
the model base. Ported: ``binary_cross_entropy``,
``softmax_cross_entropy`` and ``l2_loss``; the focal and JRC losses
raise NotImplementedError in ``create_loss_fn``.
"""

from typing import Any, Dict

import torch
import torch.nn.functional as F


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


def create_loss_fn(loss_config) -> Dict[str, Any]:
    """LossConfig proto -> {name, num_class, fn(logits or preds, labels)}."""
    which = loss_config.WhichOneof("loss")
    cfg = getattr(loss_config, which)
    if which == "binary_cross_entropy":
        ls = cfg.label_smoothing
        return {"name": which, "num_class": 1,
                "fn": lambda x, y: binary_cross_entropy(x, y, ls)}
    if which == "softmax_cross_entropy":
        ls = cfg.label_smoothing
        return {"name": which, "num_class": 2,
                "fn": lambda x, y: softmax_cross_entropy(x, y, ls)}
    if which == "l2_loss":
        return {"name": which, "num_class": 1, "fn": l2_loss}
    raise NotImplementedError(f"loss {which} is not ported")

"""Loss functions.

Counterpart of torcheasyrec_tpu/losses/__init__.py. Only
``binary_cross_entropy`` is ported; softmax cross entropy, L2, focal and
JRC losses wait for the models that use them.
"""

import torch


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

"""The behaviour-to-interest capsule layer of MIND, with dynamic routing.

Counterpart of torcheasyrec_tpu/modules/capsule.py. A bilinear map takes
the history [B, L, D] to low capsules [B, L, high_dim]; ``num_iters``
rounds of routing (a masked softmax over the K interests of the routing
logits, times ``routing_logits_scale``) sum them into K interest capsules,
squashed. The routing logits start from the fixed parameter
``routing_logits`` [max_k, max_seq_len], which gets no gradient, and grow
by the agreement of interests and low capsules; every round but the last
routes detached low capsules. A user with a history of length n has
``ceil(log2 n)`` interests, between 1 and ``max_k`` (``max_k`` with
``const_caps_num``).
"""

from typing import Any, Tuple

import torch
from torch import nn

# the logit of a masked (interest, behaviour) pair
_MASKED = float(-(2 ** 31) + 1)


def squash(x: torch.Tensor, pow_: float = 1.0) -> torch.Tensor:
    """x scaled by (|x|^2 / (1 + |x|^2))^pow / |x|, in fp32, cast back."""
    n2 = x.float().square().sum(-1, keepdim=True)
    scale = (n2 / (1.0 + n2)) ** pow_ * torch.rsqrt(n2 + 1e-9)
    return (x * scale).to(x.dtype)


class CapsuleLayer(nn.Module):
    def __init__(
        self,
        input_dim: int,
        generator: torch.Generator,
        max_k: int = 5,
        max_seq_len: int = 64,
        high_dim: int = 64,
        num_iters: int = 3,
        routing_logits_scale: float = 20.0,
        routing_logits_stddev: float = 1.0,
        squash_pow: float = 1.0,
        const_caps_num: bool = False,
        **_: Any,
    ) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.max_k = max_k
        self.max_seq_len = max_seq_len
        self.high_dim = high_dim
        self.num_iters = num_iters
        self.scale = routing_logits_scale
        self.squash_pow = squash_pow
        self.const_caps_num = const_caps_num
        dev = generator.device
        self.bilinear = nn.Parameter(torch.randn(
            input_dim, high_dim, generator=generator, device=dev)
            * input_dim ** -0.5)
        # a parameter, as in the JAX package, that no loss reaches: the
        # dense optimizer sees a zero gradient and leaves it as it is
        self.routing_logits = nn.Parameter(torch.randn(
            max_k, max_seq_len, generator=generator, device=dev)
            * routing_logits_stddev)

    def output_dim(self) -> int:
        return self.high_dim * self.max_k

    def forward(self, seq: torch.Tensor, lengths: torch.Tensor,
                compute_dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """seq [B, L, D], lengths [B] -> (interests [B, K, high_dim],
        interest mask [B, K])."""
        b, seq_len, _ = seq.shape
        u = (seq @ self.bilinear.to(compute_dtype)).to(seq.dtype)
        pos = torch.arange(seq_len, device=seq.device)
        valid = pos[None, :] < lengths.long()[:, None]  # [B, L]
        if self.const_caps_num:
            k_num = torch.full((b,), self.max_k, device=seq.device)
        else:
            k_num = torch.ceil(torch.log2(
                lengths.float().clamp(min=1.0))).long().clamp(1, self.max_k)
        cap_mask = (torch.arange(self.max_k, device=seq.device)[None, :]
                    < k_num[:, None])  # [B, K]
        logits = self.routing_logits[:self.max_k, :seq_len].detach()[
            None].expand(b, -1, -1)
        u_detached = u.detach()
        routed = valid[:, None, :] & cap_mask[:, :, None]
        interests = None
        for it in range(self.num_iters):
            last = it + 1 == self.num_iters
            w = torch.softmax(torch.where(
                routed, logits * self.scale, logits.new_full((), _MASKED)),
                dim=1)
            # padded behaviours route nowhere
            w = w * valid[:, None, :].to(w.dtype)
            u_in = u if last else u_detached
            s = (w.to(u_in.dtype) @ u_in).to(u.dtype)
            interests = squash(s, self.squash_pow)
            if not last:
                logits = logits + interests.detach().float() @ (
                    u_detached.float().transpose(1, 2))
        return interests, cap_mask

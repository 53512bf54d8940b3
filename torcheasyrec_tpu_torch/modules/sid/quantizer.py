"""Vector and residual quantizers for semantic-ID generation.

Counterpart of torcheasyrec_tpu/modules/sid/quantizer.py. Distances are
computed as the JAX package writes them (the l2 form x^2 + c^2 - 2 x c^T
and the cosine form 1 - x_n c_n^T, fp32, not ``torch.cdist``), and the
codes are the first index of the least distance (of the largest Sinkhorn
assignment), so that ties break alike. Straight-through (``ste``) and
gumbel-softmax forward modes. In ``ste`` mode the quantized value is
``x + (hard - x).detach()``: its gradient reaches ``x`` alone, so the
codebook takes no gradient from any loss built on it, as in the JAX
package. The gumbel noise is drawn from the quantizer's
``torch.Generator`` (uniform on [1e-9, 1), as the JAX package draws it
from its step key); there is no generator that reproduces JAX's draw.
"""

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from torcheasyrec_tpu_torch.parallel.mesh import global_count, logsumexp_rows


def pairwise_dist(x: torch.Tensor, codebook: torch.Tensor,
                  distance_type: str) -> torch.Tensor:
    """[B, D] x [K, D] -> [B, K] distances (smaller is closer)."""
    if distance_type == "cosine":
        xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        cn = codebook * torch.rsqrt(
            (codebook * codebook).sum(-1, keepdim=True) + 1e-12)
        return 1.0 - xn @ cn.T
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (codebook * codebook).sum(-1)
    return x2 + c2[None] - 2 * (x @ codebook.T)


def sinkhorn_assign(dist: torch.Tensor, iters: int = 5,
                    epsilon: float = 10.0, shard=None) -> torch.Tensor:
    """Balanced soft assignment [B, K] by Sinkhorn iterations over
    -dist / epsilon: rows normalised, then columns to B / K each. The
    column step reduces over the whole batch: over several ranks
    (``shard``) ``dist`` is this rank's rows, the columns' logsumexp
    spans every rank's and B is the global row count."""
    log_p = -dist / epsilon
    b, k = dist.shape
    if shard is not None:
        b = int(global_count(b, shard))
    log_ratio = float(np.log(np.float32(b) / np.float32(k)))
    for _ in range(iters):
        log_p = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
        log_p = log_p - logsumexp_rows(log_p, shard) + log_ratio
    return torch.exp(log_p)


def gumbel_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """The uniform draw under the gumbel noise, on [1e-9, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return 1e-9 + (1.0 - 1e-9) * u


class VectorQuantizer(nn.Module):
    """One codebook ``codebook`` [K, D], drawn from N(0, 1/D). ``shard``
    (the model's ranks, set by ``SidRqvae.attach_shard``) is what
    Sinkhorn's column step spans."""

    shard = None

    def __init__(self, dim: int, codebook_size: int,
                 generator: torch.Generator, forward_mode: str = "ste",
                 distance_type: str = "l2", sinkhorn_iters: int = 0,
                 sinkhorn_epsilon: float = 10.0) -> None:
        super().__init__()
        self.forward_mode = forward_mode
        self.distance_type = distance_type
        self.sinkhorn_iters = sinkhorn_iters
        self.sinkhorn_epsilon = sinkhorn_epsilon
        self._generator = generator
        self.codebook = nn.Parameter(torch.randn(
            codebook_size, dim, generator=generator,
            device=generator.device) * dim ** -0.5)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, D] -> (quantized [B, D] in x's dtype, codes [B], dist
        [B, K]). Sinkhorn and the gumbel noise act in training only."""
        codebook = self.codebook
        xf = x.float()
        dist = pairwise_dist(xf, codebook, self.distance_type)
        if self.training and self.sinkhorn_iters > 0:
            codes = torch.argmax(sinkhorn_assign(
                dist, self.sinkhorn_iters, self.sinkhorn_epsilon,
                self.shard), dim=-1)
        else:
            codes = torch.argmin(dist, dim=-1)
        if self.forward_mode == "gumbel_softmax" and self.training:
            u = gumbel_uniform(dist.shape, self._generator)
            g = -torch.log(-torch.log(u + 1e-9))
            soft = torch.softmax((-dist + g) / 0.5, dim=-1)
            q = soft @ codebook
        else:
            hard = codebook[codes]
            q = x + (hard - xf).detach()
        return q.to(x.dtype), codes, dist


class ResidualQuantizer(nn.Module):
    """A stack of vector quantizers ``vq_<i>`` over successive
    residuals, each residual optionally l2-normalised first."""

    def __init__(self, dim: int, codebook_sizes: List[int],
                 generator: torch.Generator, forward_mode: str = "ste",
                 distance_type: str = "l2",
                 normalize_residuals: bool = False,
                 sinkhorn_iters: int = 0,
                 sinkhorn_epsilon: float = 10.0) -> None:
        super().__init__()
        self.normalize_residuals = normalize_residuals
        self.num_layers = len(codebook_sizes)
        for i, k in enumerate(codebook_sizes):
            self.add_module(f"vq_{i}", VectorQuantizer(
                dim, k, generator, forward_mode, distance_type,
                sinkhorn_iters, sinkhorn_epsilon))

    def layers(self) -> List[VectorQuantizer]:
        return [getattr(self, f"vq_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           List[Tuple[torch.Tensor, torch.Tensor]]]:
        """-> (quantized [B, D], codes [B, L], per level (residual in,
        quantized)). The residual passes on less the detached quantized
        value."""
        residual = x
        total_q = torch.zeros_like(x)
        codes, levels = [], []
        for vq in self.layers():
            r_in = residual
            if self.normalize_residuals:
                r_in = r_in * torch.rsqrt(
                    (r_in.float() ** 2).sum(-1, keepdim=True) + 1e-12
                ).to(r_in.dtype)
            q, c, _ = vq(r_in)
            codes.append(c)
            levels.append((r_in, q))
            total_q = total_q + q
            residual = residual - q.detach()
        return total_q, torch.stack(codes, dim=-1), levels

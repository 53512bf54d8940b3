"""Semantic-ID generation models: RQ-VAE and RQ-KMeans.

Counterpart of torcheasyrec_tpu/models/sid_models.py. Both encode an
item vector (the main group's dense slots) and residual-quantize it into
L codes (``modules/sid/quantizer.py``). ``SidRqvae`` trains an MLP
encoder and decoder and the codebooks against the reconstruction loss
(``l2``, ``l1`` or ``cos``), the commitment loss (``latent_weight``
[encoder toward quantized, quantized toward encoder], default [1, 0.5])
and, with a ``contrastive_config``, an in-batch InfoNCE between item and
pair latents (weighted by the pair-flag group where it is in the
batch). ``SidRqkmeans`` has no encoder: the train loop hands it each
host batch (``collect_from_batch``), and at the end of training
(``on_train_end``) it fits each level's codebook by Lloyd's k-means on
the first ``train_sample_size`` samples, on the model's device. The
fit's samples are not checkpointed, as in the JAX package: a resumed run
fits on what it saw since the resume.

Predictions hold ``codes`` [B, L] (the semantic ids), ``recon`` and the
``__``-prefixed internals that predict does not write. The eval metrics
are ``unique_ratio`` (distinct code tuples over rows) and ``rel_loss``
(mean symmetric relative L1 of ``recon`` against the input), both in
float64 on the host.

Sinkhorn's column normalisation, the contrastive loss's in-batch
negatives and RQ-KMeans' sample buffer reduce over the whole batch; at
world size > 1 those configurations raise NotImplementedError.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.metrics import _RowState, _SumState
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.modules.mlp import MLP
from torcheasyrec_tpu_torch.modules.sid.quantizer import ResidualQuantizer

_KMEANS_ITERS = 20


class UniqueRatio(_RowState):
    """Fraction of distinct code tuples among the rows."""

    _lists = ("_codes",)

    def __init__(self, **kw) -> None:
        self.reset()

    def reset(self) -> None:
        self._codes: List[np.ndarray] = []

    def update(self, preds, labels=None, **kw) -> None:
        self._codes.append(np.asarray(preds))

    def compute(self) -> float:
        c = np.concatenate(self._codes)
        return float(len({tuple(row) for row in c}) / max(len(c), 1))


class RelativeL1(_SumState):
    """Mean symmetric relative L1, |t - p| / (max(|t|, |p|) + epsilon),
    over every element."""

    def __init__(self, epsilon: float = 1e-4, **kw) -> None:
        self.eps = epsilon
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._n = 0

    def update(self, preds, target=None, **kw) -> None:
        p = np.asarray(preds, np.float64)
        t = np.asarray(target, np.float64)
        rel = np.abs(t - p) / (np.maximum(np.abs(t), np.abs(p)) + self.eps)
        self._sum += float(rel.sum())
        self._n += rel.size

    def compute(self) -> float:
        return self._sum / max(self._n, 1)


class _SidModel(BaseModel):
    """The SID metrics, fed on the host."""

    def init_metrics(self) -> List[Dict[str, Any]]:
        return [
            {"name": "unique_ratio", "metric": UniqueRatio(), "config": {}},
            {"name": "rel_loss", "metric": RelativeL1(), "config": {}},
        ]

    def update_metrics(self, metrics, predictions, batch: Batch) -> None:
        for m in metrics:
            if m["name"] == "rel_loss":
                m["metric"].update(
                    predictions["recon"].float().cpu().numpy(),
                    predictions["__x"].float().cpu().numpy())
            else:
                m["metric"].update(predictions["codes"].cpu().numpy())


class SidRqvae(_SidModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._build_embedding_group()
        mc = self._model_config
        g = self._generator
        in_dim = self.embedding_group.group_total_dim(self._main_group())
        self.embed_dim = int(mc.embed_dim or 64)
        hidden = list(mc.hidden_dims) or [max(in_dim // 2, self.embed_dim)]
        self.encoder = MLP(in_dim, hidden + [self.embed_dim], g,
                           activation="nn.ReLU")
        self.decoder = MLP(self.embed_dim, hidden[::-1] + [in_dim], g,
                           activation="nn.ReLU")
        sk = mc.sinkhorn_config
        self._sinkhorn_iters = (int(sk.iters) if mc.HasField(
            "sinkhorn_config") and sk.enabled else 0)
        self.rq = ResidualQuantizer(
            self.embed_dim, list(mc.codebook) or [256, 256, 256], g,
            forward_mode=mc.forward_mode or "ste",
            distance_type="cosine" if mc.distance_type == "cosine" else "l2",
            normalize_residuals=bool(mc.normalize_residuals),
            sinkhorn_iters=self._sinkhorn_iters,
            sinkhorn_epsilon=float(sk.epsilon or 10.0))
        self._commitment_w = [1.0, 0.5]
        self._recon_type = "l2"
        for lc in self._loss_cfgs:
            which = lc.WhichOneof("sid_loss")
            if which == "commitment_loss" and len(
                    lc.commitment_loss.latent_weight):
                self._commitment_w = list(lc.commitment_loss.latent_weight)
            if which == "recon_loss":
                self._recon_type = lc.recon_loss.recon_type or "l2"
        # the pair latents exist only with a contrastive_config; a
        # contrastive_loss entry alone adds no loss, as in the JAX package
        self._contrastive_groups = None
        if mc.HasField("contrastive_config"):
            self._contrastive_groups = (
                mc.contrastive_config.pair_feature_group,
                mc.contrastive_config.pair_flag_feature_group)

    def unsharded_reduction(self) -> Optional[str]:
        if self._sinkhorn_iters > 0:
            return "Sinkhorn's balanced assignment over the batch"
        if self._contrastive_groups:
            return "the contrastive loss's in-batch negatives"
        return None

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, Any]:
        dt = self.compute_dtype
        x = grouped[self._main_group()].float()
        z = self.encoder(x, dt)
        zq, codes, levels = self.rq(z)
        recon = self.decoder(zq, dt)
        preds: Dict[str, Any] = {"codes": codes, "recon": recon, "__x": x,
                                 "__z": z, "__levels": levels}
        if self._contrastive_groups:
            pair_g, flag_g = self._contrastive_groups
            if pair_g in grouped:
                preds["__pair_z"] = self.encoder(grouped[pair_g].float(), dt)
                if flag_g in grouped:
                    preds["__pair_flag"] = grouped[flag_g][..., 0]
        return preds

    def loss(self, predictions: Dict[str, Any],
             batch: Batch) -> Dict[str, torch.Tensor]:
        mean = self.batch_mean
        x = predictions["__x"]
        recon = predictions["recon"].float()
        if self._recon_type == "l1":
            recon_loss = mean((recon - x).abs())
        elif self._recon_type == "cos":
            num = (recon * x).sum(-1)
            den = torch.sqrt((recon * recon).sum(-1) * (x * x).sum(-1)
                             + 1e-12)
            recon_loss = mean(1.0 - num / den)
        else:
            recon_loss = mean((recon - x) ** 2)
        w_e, w_q = (self._commitment_w + [0.5, 0.5])[:2]
        commit = x.new_zeros(())
        for r_in, q in predictions["__levels"]:
            r, qf = r_in.float(), q.float()
            commit = (commit + w_e * mean((r - qf.detach()) ** 2)
                      + w_q * mean((r.detach() - qf) ** 2))
        losses = {"recon_loss": recon_loss, "commitment_loss": commit}
        if "__pair_z" in predictions:
            z = predictions["__z"].float()
            pz = predictions["__pair_z"].float()
            zn = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True)
                      + 1e-12)
            pn = pz / (torch.linalg.vector_norm(pz, dim=-1, keepdim=True)
                       + 1e-12)
            logp = torch.log_softmax(zn @ pn.T / 0.1, dim=-1)
            per = -logp.diagonal()
            flag = predictions.get("__pair_flag")
            if flag is not None:
                w = (flag > 0).float()
                losses["contrastive_loss"] = (
                    (per * w).sum() / torch.clamp(w.sum(), min=1.0))
            else:
                losses["contrastive_loss"] = per.mean()
        return losses


def lloyd_kmeans(x: torch.Tensor, k: int, iters: int = _KMEANS_ITERS,
                 seed: int = 0) -> torch.Tensor:
    """Lloyd's k-means of ``x`` [N, D] (fp32, on its device) into ``k``
    centroids, as the JAX package's numpy fit: the initial centroids are
    the rows ``np.random.default_rng(seed).choice`` picks, then (where
    k > N) normal draws of that generator; each iteration assigns by the
    l2 form of ``pairwise_dist`` and moves each centroid to its rows'
    mean (``index_add_`` over the counts); an empty cluster keeps its
    centroid."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    pick = rng.choice(n, size=min(k, n), replace=False)
    centroids = x[torch.from_numpy(pick).to(x.device)].clone()
    if centroids.shape[0] < k:
        extra = rng.normal(size=(k - n, x.shape[1])).astype(np.float32)
        centroids = torch.cat([centroids, torch.from_numpy(extra).to(
            x.device)])
    x2 = (x * x).sum(1, keepdim=True)
    ones = torch.ones(n, device=x.device)
    for _ in range(iters):
        d = x2 + (centroids * centroids).sum(1) - 2 * (x @ centroids.T)
        assign = torch.argmin(d, dim=1)
        sums = torch.zeros_like(centroids).index_add_(0, assign, x)
        counts = torch.zeros(k, device=x.device).index_add_(0, assign, ones)
        hit = counts > 0
        centroids = torch.where(hit[:, None],
                                sums / counts.clamp(min=1)[:, None],
                                centroids)
    return centroids


class SidRqkmeans(_SidModel):
    """No encoder: item vectors are collected during training and each
    level's codebook is fitted by k-means at ``on_train_end``."""

    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        self._build_embedding_group()
        mc = self._model_config
        self._codebooks = list(mc.codebook) or [256, 256]
        self._normalize = bool(mc.normalize_residuals)
        self._sample_cap = int(mc.train_sample_size or 0) or 200_000
        self._buffer: List[np.ndarray] = []
        self._buffered = 0
        dim = self.embedding_group.group_total_dim(self._main_group())
        self.rq = ResidualQuantizer(dim, self._codebooks, self._generator,
                                    normalize_residuals=self._normalize)

    def unsharded_reduction(self) -> Optional[str]:
        return "the k-means fit over one process's sample buffer"

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, Any]:
        x = grouped[self._main_group()].float()
        zq, codes, levels = self.rq(x)
        return {"codes": codes, "recon": zq, "__x": x, "__levels": levels}

    def loss(self, predictions: Dict[str, Any],
             batch: Batch) -> Dict[str, torch.Tensor]:
        # nothing trains: the quantization error is logged only
        err = (predictions["__x"] - predictions["recon"].float()) ** 2
        return {"quant_error": err.mean().detach()}

    def collect(self, batch_x: np.ndarray) -> None:
        if self._buffered < self._sample_cap:
            self._buffer.append(np.asarray(batch_x, np.float32))
            self._buffered += len(batch_x)

    def collect_from_batch(self, batch: Batch) -> None:
        """Buffer the batch's item vectors, the "all" group's dense slots
        in group order, from the batch on the host (the loader's pinned
        copy, ``batch.host``, where the batch is on the device)."""
        host = getattr(batch, "host", None) or batch
        parts = [host.dense_features[key].values.cpu().numpy()
                 for kind, key, _ in self.embedding_group._group_slots.get(
                     "all", []) if kind == "dense"
                 and key in host.dense_features]
        if parts:
            self.collect(np.concatenate(parts, axis=-1))

    @torch.no_grad()
    def on_train_end(self) -> None:
        """Fit the codebooks level by level on the buffered samples (at
        most ``train_sample_size``), on the model's device; each level
        fits the residual the previous levels leave."""
        if not self._buffer:
            return
        dev = self.rq.vq_0.codebook.device
        x = torch.from_numpy(
            np.concatenate(self._buffer)[: self._sample_cap]).to(dev)
        residual = x
        for i, (vq, k) in enumerate(zip(self.rq.layers(), self._codebooks)):
            r_in = residual
            if self._normalize:
                r_in = r_in / (torch.linalg.vector_norm(
                    r_in, dim=1, keepdim=True) + 1e-12)
            cb = lloyd_kmeans(r_in, k, seed=i)
            vq.codebook.copy_(cb)
            d = ((r_in * r_in).sum(1, keepdim=True) + (cb * cb).sum(1)
                 - 2 * (r_in @ cb.T))
            residual = residual - cb[torch.argmin(d, dim=1)]

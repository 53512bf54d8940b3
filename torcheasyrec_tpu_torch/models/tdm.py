"""TDM: tree-based deep match.

Counterpart of torcheasyrec_tpu/models/tdm.py. A rank model over the
(user, tree node) pairs that ``TDMSampler`` makes: a MultiWindowDIN
encoder (``mwdin``) attends the history of the first SEQUENCE group with
the candidate node (the group's query slots) as its query; its output,
the query itself and every other non-sequence group feed the ``final``
MLP and the ``output`` linear; BCE against the is-ancestor labels.
Retrieval is a layer-wise beam search over the tree
(``tools/tdm/retrieval.py``); the node embedding for tree building is
``EmbeddingGroup.node_embedding`` (the query slots alone).
"""

from typing import Dict

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.models.rank_model import RankModel
from torcheasyrec_tpu_torch.modules.mlp import mlp_from_config
from torcheasyrec_tpu_torch.modules.module import linear, linear_apply
from torcheasyrec_tpu_torch.modules.sequence import MultiWindowDINEncoder
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class TDM(RankModel):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        g = self._generator
        eg = self.embedding_group
        mc = self._model_config
        dims = eg.seq_group_dims()
        seq_groups = [k[: -len(".sequence")] for k in dims
                      if k.endswith(".sequence")]
        if not seq_groups:
            raise ValueError("TDM needs a SEQUENCE feature group")
        self.seq_group = seq_groups[0]
        seq_dim = dims[f"{self.seq_group}.sequence"]
        self._query_dim = dims.get(f"{self.seq_group}.query", 0)
        mw = mc.multiwindow_din
        self.mwdin = MultiWindowDINEncoder(
            sequence_dim=seq_dim, query_dim=self._query_dim or seq_dim,
            input=self.seq_group, attn_mlp=config_to_kwargs(mw.attn_mlp),
            generator=g, windows_len=list(mw.windows_len))
        self.final = mlp_from_config(
            self.mwdin.output_dim() + self._query_dim
            + sum(eg.group_total_dim(n) for n in eg.group_names()),
            config_to_kwargs(mc.final), g)
        self.output = linear(self.final.output_dim(), self._num_class, g)

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        parts = [self.mwdin(grouped, dt)]
        if self._query_dim:
            parts.append(grouped[f"{self.seq_group}.query"])
        parts += [grouped[n] for n in self.embedding_group.group_names()]
        h = self.final(torch.cat(parts, dim=-1), dt)
        return self._output_to_prediction(linear_apply(self.output, h, dt))

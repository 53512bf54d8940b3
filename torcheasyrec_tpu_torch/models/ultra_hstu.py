"""ULTRA-HSTU: DlrmHSTU with a mixture of transducers.

Counterpart of torcheasyrec_tpu/models/ultra_hstu.py. One STU stack per
configured ``hstu`` channel: the first is DlrmHSTU's own, the others are
``extra_stacks``. All channels share the preprocessor and its contextual
prefix, run over the same layer ranges and their outputs are averaged
(``HSTUTransducer._run_stack``). Each channel keeps its own mask
parameters (``max_attn_len``, SLA); a truncation split indexes the base
channel's layers and the others stop at the same depth, clamped to their
own.
"""

from torch import nn

from torcheasyrec_tpu_torch.models.dlrm_hstu import DlrmHSTU
from torcheasyrec_tpu_torch.modules.gr.stu import stu_from_config
from torcheasyrec_tpu_torch.ops import normalize_kernel
from torcheasyrec_tpu_torch.utils.config_util import config_to_kwargs


class UltraHSTU(DlrmHSTU):
    def __init__(self, model_config, features, labels, sample_weights=None,
                 **kwargs) -> None:
        super().__init__(model_config, features, labels, sample_weights,
                         **kwargs)
        kernel = normalize_kernel(self._base_model_config.kernel)
        stacks = []
        for hcfg in list(self._model_config.hstu)[1:]:
            stu_cfg = config_to_kwargs(hcfg.stu)
            if int(stu_cfg["embedding_dim"]) != self._e:
                raise ValueError(
                    "all UltraHSTU channels must share embedding_dim")
            if not hcfg.stu.HasField("num_layers"):
                stu_cfg["num_layers"] = int(hcfg.attn_num_layers)
            st = stu_from_config(stu_cfg, self._generator, kernel=kernel)
            st.set_contextual_seq_len(self.transducer.pre.n_ctx)
            stacks.append(st)
        self.extra_stacks = nn.ModuleList(stacks)
        self.transducer.extra_stacks = list(self.extra_stacks)

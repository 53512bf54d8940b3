"""Model registry: importing this package registers the ported models so
``create_model`` resolves a ModelConfig by its proto message name."""

from torcheasyrec_tpu_torch.models.dat import DAT  # noqa: F401
from torcheasyrec_tpu_torch.models.dbmtl import DBMTL  # noqa: F401
from torcheasyrec_tpu_torch.models.dc2vr import DC2VR  # noqa: F401
from torcheasyrec_tpu_torch.models.dcn import DCNV1, DCNV2  # noqa: F401
from torcheasyrec_tpu_torch.models.deepfm import DeepFM  # noqa: F401
from torcheasyrec_tpu_torch.models.dlrm import DLRM  # noqa: F401
from torcheasyrec_tpu_torch.models.dlrm_hstu import DlrmHSTU  # noqa: F401
from torcheasyrec_tpu_torch.models.dssm import DSSM, DSSMV2  # noqa: F401
from torcheasyrec_tpu_torch.models.hstu_match import HSTUMatch  # noqa: F401
from torcheasyrec_tpu_torch.models.masknet import MaskNet  # noqa: F401
from torcheasyrec_tpu_torch.models.mind import MIND  # noqa: F401
from torcheasyrec_tpu_torch.models.mmoe import MMoE  # noqa: F401
from torcheasyrec_tpu_torch.models.multi_task_rank import (  # noqa: F401
    SimpleMultiTask,
)
from torcheasyrec_tpu_torch.models.pepnet import PEPNet  # noqa: F401
from torcheasyrec_tpu_torch.models.multi_tower import (  # noqa: F401
    MultiTower,
    MultiTowerDIN,
)
from torcheasyrec_tpu_torch.models.ple import PLE  # noqa: F401
from torcheasyrec_tpu_torch.models.rocket_launching import (  # noqa: F401
    RocketLaunching,
)
from torcheasyrec_tpu_torch.models.sid_models import (  # noqa: F401
    SidRqkmeans,
    SidRqvae,
)
from torcheasyrec_tpu_torch.models.tdm import TDM  # noqa: F401
from torcheasyrec_tpu_torch.models.ultra_hstu import UltraHSTU  # noqa: F401
from torcheasyrec_tpu_torch.models.wide_and_deep import WideAndDeep  # noqa: F401
from torcheasyrec_tpu_torch.models.wukong import WuKong  # noqa: F401
from torcheasyrec_tpu_torch.models.xdeepfm import XDeepFM
from torcheasyrec_tpu_torch.models.model import _MODEL_CLASS_MAP, BaseModel

# proto message names that differ from the class names
_MODEL_CLASS_MAP["xDeepFM"] = XDeepFM


def create_model(model_config, features, labels, sample_weights=None,
                 **kwargs) -> BaseModel:
    """ModelConfig proto -> model instance; unported models raise
    NotImplementedError."""
    which = model_config.WhichOneof("model")
    if which is None:
        raise ValueError("model_config.model oneof is not set")
    cls = BaseModel.create_class(type(getattr(model_config, which)).__name__)
    return cls(model_config, features, labels, sample_weights, **kwargs)

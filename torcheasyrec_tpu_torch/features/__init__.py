from torcheasyrec_tpu_torch.features.feature import (  # noqa: F401
    BaseFeature,
    create_features,
    create_fg_json,
)
from torcheasyrec_tpu_torch.features.id_feature import IdFeature  # noqa: F401
from torcheasyrec_tpu_torch.features.other_features import (  # noqa: F401
    BoolMaskFeature,
    ComboFeature,
    CombineFeature,
    CustomFeature,
    ExprFeature,
    KvDotProduct,
    LookupFeature,
    MatchFeature,
    OverlapFeature,
    TokenizeFeature,
    register_custom_op,
)
from torcheasyrec_tpu_torch.features.raw_feature import RawFeature  # noqa: F401

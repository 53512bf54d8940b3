"""BaseModel: model registry and the forward used for eval and predict.

Counterpart of torcheasyrec_tpu/models/model.py. A model is an
``nn.Module`` that builds its EmbeddingGroup and dense submodules in
``__init__`` and implements ``predict(grouped, batch)``. Losses and
metrics arrive with training.
"""

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.features.feature import BaseFeature
from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
from torcheasyrec_tpu_torch.utils.load_class import get_register_class_meta

_MODEL_CLASS_MAP: Dict[str, type] = {}
_meta = get_register_class_meta(_MODEL_CLASS_MAP)


class BaseModel(nn.Module, metaclass=_meta):
    def __init__(
        self,
        model_config: Any,  # ModelConfig proto
        features: List[BaseFeature],
        labels: List[str],
        sample_weights: Optional[List[str]] = None,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if model_config.HasField("variational_dropout"):
            raise NotImplementedError("variational_dropout is not ported")
        self._base_model_config = model_config
        self._features = features
        self.compute_dtype = compute_dtype
        self._generator = generator or torch.Generator()
        which = model_config.WhichOneof("model")
        self._model_config = getattr(model_config, which) if which else None
        self.embedding_group: Optional[EmbeddingGroup] = None

    def _build_embedding_group(self) -> None:
        self.embedding_group = EmbeddingGroup(
            self._features, list(self._base_model_config.feature_groups),
            self._generator,
        )

    def predict(self, grouped: Dict[str, torch.Tensor],
                batch: Batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Full forward for eval/predict."""
        grouped = self.embedding_group(batch, self.compute_dtype)
        return self.predict(grouped, batch)

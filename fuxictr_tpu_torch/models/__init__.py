"""Models: ``RankModel`` (training and inference) and the registry of the
zoo."""

from fuxictr_tpu_torch.models.base import RankModel
from fuxictr_tpu_torch.models.registry import (MODEL_REGISTRY, get_model,
                                               register_model)

__all__ = ["MODEL_REGISTRY", "RankModel", "get_model", "register_model"]

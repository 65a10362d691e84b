"""Model zoo: importing it registers every ported model."""

from fuxictr_tpu_torch.models.zoo import longctr  # noqa: F401

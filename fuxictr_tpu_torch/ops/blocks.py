"""Logistic regression and the factorization machine, ported from
``fuxictr_tpu.ops.blocks``. The LR weights are a dim-1 fused embedding
(``lr.embedding.table_d1``, plus ``numeric_d1`` for numeric fields); the
FM's pairwise term uses the sum-square identity on the ``[B, F, D]``
embedding tensor."""

import torch
from torch import nn

from fuxictr_tpu_torch.ops.embedding import FeatureEmbedding


class LogisticRegression(nn.Module):
    """``sum_f w_f(x_f) + bias``: one weight per id (or per numeric field,
    times its value), ``[B, 1]``. Sequence fields are not ported (the JAX
    block sum-pools them)."""

    def __init__(self, feature_map, use_bias=True, generator=None):
        super().__init__()
        self.embedding = FeatureEmbedding(
            feature_map, 1, force_dim=1, use_pretrain=False,
            use_sharing=False, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1)) if use_bias else None

    def forward(self, batch):
        weights = self.embedding(batch)                    # [B, F, 1]
        logit = torch.sum(weights, dim=(1, 2))[:, None]
        return logit if self.bias is None else logit + self.bias


def fm_pairwise_sum(feature_emb):
    """``0.5 * [(sum_f v_f)^2 - sum_f v_f^2]`` summed over the embedding
    dim: ``[B, F, D]`` -> ``[B, 1]``, in the input's type."""
    sum_of_emb = torch.sum(feature_emb, dim=1)
    sq_of_sum = sum_of_emb * sum_of_emb
    sum_of_sq = torch.sum(feature_emb * feature_emb, dim=1)
    return 0.5 * torch.sum(sq_of_sum - sum_of_sq, dim=-1, keepdim=True)


class FactorizationMachine(nn.Module):
    """The LR term plus the FM pairwise term of the embedding tensor."""

    def __init__(self, feature_map, generator=None):
        super().__init__()
        self.lr = LogisticRegression(feature_map, generator=generator)

    def forward(self, batch, feature_emb):
        return self.lr(batch) + fm_pairwise_sum(feature_emb)

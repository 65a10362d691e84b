"""Feature-interaction ranking models, ported from
``fuxictr_tpu.models.zoo.ranking``: DeepFM and DCNv2. Each is a
``RankModel`` whose layers are named as the flax net's modules
(``embedding``, ``fm``, ``mlp``, ``crossnet``, ``stacked_dnn``,
``parallel_dnn``, ``fc``), built on the CPU from ``self.generator`` and
moved to the model's device. The forward takes a flat batch dict and
returns ``{"y_pred": logits}``."""

import torch
from torch import nn

from fuxictr_tpu_torch.models.base import RankModel
from fuxictr_tpu_torch.models.registry import register_model
from fuxictr_tpu_torch.ops.blocks import FactorizationMachine
from fuxictr_tpu_torch.ops.common import Dense, xavier_normal_
from fuxictr_tpu_torch.ops.embedding import FeatureEmbedding
from fuxictr_tpu_torch.ops.interactions import CrossNetMix, CrossNetV2
from fuxictr_tpu_torch.ops.mlp import MLP_Block


def _flat(x):
    return x.reshape(x.shape[0], -1)


def _width(embedding):
    """Width of a FeatureEmbedding's flattened output."""
    return sum(plan["dim"] for plan in embedding.layout.fields.values())


@register_model
class DeepFM(RankModel):
    """DeepFM: the FM (LR + pairwise) logit plus an MLP over the
    flattened embeddings."""

    def __init__(self, feature_map, model_id="DeepFM", embedding_dim=10,
                 hidden_units=(64, 64, 64), hidden_activations="relu",
                 net_dropout=0.0, batch_norm=False, **kwargs):
        super().__init__(feature_map, model_id=model_id, **kwargs)
        g = self.generator
        self.embedding = FeatureEmbedding(feature_map, embedding_dim,
                                          generator=g)
        self.fm = FactorizationMachine(feature_map, generator=g)
        self.mlp = MLP_Block(_width(self.embedding), tuple(hidden_units),
                             hidden_activations, output_dim=1,
                             batch_norm=batch_norm,
                             dropout_rates=net_dropout, generator=g)
        self._finish_build()

    def forward(self, batch):
        emb = self.embedding(batch)                            # [B, F, D]
        y = self.fm(batch, emb) + self.mlp(_flat(emb))
        return {"y_pred": y}


_STRUCTURES = ("crossnet_only", "stacked", "parallel", "stacked_parallel")


@register_model
class DCNv2(RankModel):
    """DCNv2 in its four structures: the cross network alone
    (``crossnet_only``), an MLP on top of it (``stacked``), an MLP beside
    it on the embeddings (``parallel``), or both (``stacked_parallel``);
    then one Dense to the logit. ``use_low_rank_mixture`` takes
    ``CrossNetMix`` for ``CrossNetV2``."""

    def __init__(self, feature_map, model_id="DCNv2", embedding_dim=10,
                 model_structure="parallel", use_low_rank_mixture=False,
                 low_rank=32, num_experts=4, num_cross_layers=3,
                 stacked_dnn_hidden_units=(), parallel_dnn_hidden_units=(),
                 dnn_activations="relu", net_dropout=0.0, batch_norm=False,
                 **kwargs):
        if model_structure not in _STRUCTURES:
            raise ValueError(
                f"model_structure={model_structure} not supported.")
        super().__init__(feature_map, model_id=model_id, **kwargs)
        self.model_structure = model_structure
        g = self.generator
        self.embedding = FeatureEmbedding(feature_map, embedding_dim,
                                          generator=g)
        input_dim = _width(self.embedding)
        if use_low_rank_mixture:
            self.crossnet = CrossNetMix(input_dim, num_cross_layers,
                                        low_rank, num_experts, generator=g)
        else:
            self.crossnet = CrossNetV2(input_dim, num_cross_layers,
                                       generator=g)
        mlp = dict(hidden_activations=dnn_activations,
                   dropout_rates=net_dropout, batch_norm=batch_norm,
                   generator=g)
        final_dim = input_dim
        if model_structure in ("stacked", "stacked_parallel"):
            self.stacked_dnn = MLP_Block(
                input_dim, tuple(stacked_dnn_hidden_units), **mlp)
            final_dim = (stacked_dnn_hidden_units or [input_dim])[-1]
        if model_structure in ("parallel", "stacked_parallel"):
            self.parallel_dnn = MLP_Block(
                input_dim, tuple(parallel_dnn_hidden_units), **mlp)
            final_dim += (parallel_dnn_hidden_units or [input_dim])[-1]
        self.fc = Dense(final_dim, 1)
        xavier_normal_(self.fc.weight.data, g)
        nn.init.zeros_(self.fc.bias)
        self._finish_build()

    def forward(self, batch):
        emb = self.embedding(batch, flatten_emb=True)           # [B, D]
        final = self.crossnet(emb)
        if self.model_structure in ("stacked", "stacked_parallel"):
            final = self.stacked_dnn(final)
        if self.model_structure in ("parallel", "stacked_parallel"):
            final = torch.cat([final, self.parallel_dnn(emb)], dim=-1)
        return {"y_pred": self.fc(final)}

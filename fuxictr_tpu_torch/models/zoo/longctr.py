"""Long-sequence CTR models, ported from ``fuxictr_tpu.models.zoo.longctr``:
SIM with the soft search unit, for training and inference.

Batch layout (``data/longctr_loader.py``): flat user/context features, the
``"__items__"`` dict of item features over ``[B*(L+1)]`` rows (history,
then target) and ``"__seq_mask__"`` ``[B, L]``.
"""

import torch

from fuxictr_tpu_torch.data.longctr_loader import ITEMS_KEY, SEQ_MASK_KEY
from fuxictr_tpu_torch.models.base import RankModel
from fuxictr_tpu_torch.models.registry import register_model
from fuxictr_tpu_torch.ops.attention import MultiHeadTargetAttention
from fuxictr_tpu_torch.ops.common import Dense, einsum, xavier_normal_
from fuxictr_tpu_torch.ops.embedding import FeatureEmbedding
from fuxictr_tpu_torch.ops.mlp import MLP_Block


def _field_dims(feature_map, embedding_dim, item):
    return sum(spec.get("embedding_dim", embedding_dim)
               for spec in feature_map.features.values()
               if spec["type"] != "meta"
               and (spec.get("source") == "item") == item)


class _LongCTRBase(RankModel):
    """Shared front end: embed the flat user/context features and the item
    rows, the latter reshaped to ``[B, L+1, item_dim]``."""

    def _encode(self, batch):
        emb_list = []
        ctx = {k: v for k, v in batch.items()
               if k in self.feature_map.features}
        if ctx:
            emb_list.append(self.embedding(ctx, flatten_emb=True))
        item_emb = self.embedding(batch[ITEMS_KEY], flatten_emb=True)
        mask = batch[SEQ_MASK_KEY]
        item_emb = item_emb.reshape(mask.shape[0], -1, self.item_dim)
        return emb_list, item_emb, mask


def topk_gather(seq_emb, mask, scores, k):
    """Embeddings and mask of the ``k`` highest-scoring positions:
    ``([B, k, D], [B, k])``. Of tied scores the lower position comes first,
    as in ``jax.lax.top_k``: in bfloat16, distinct items can tie."""
    top_idx = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :k]
    emb = torch.gather(seq_emb, 1,
                       top_idx[..., None].expand(-1, -1, seq_emb.shape[-1]))
    return emb, torch.gather(mask, 1, top_idx)


@register_model
class SIM(_LongCTRBase):
    """SIM, soft search: GSU qk-scores -> top-k -> ESU target attention.
    The auxiliary GSU head feeds only the training loss,
    ``alpha * GSU + beta * ESU`` (:meth:`add_loss`). ``net_dropout`` drops
    in both MLPs; ``attention_dropout`` in both attentions (on the CPU
    only: the kernel has none). ``_longctr`` tells ``run_expid`` to feed it
    through ``LongCTRDataLoader``."""

    _longctr = True

    def __init__(self, feature_map, model_id="SIM", embedding_dim=10,
                 dnn_hidden_units=(512, 128, 64), dnn_activations="relu",
                 attention_dropout=0.0, attention_dim=64, num_heads=1,
                 gsu_type="soft", short_seq_len=50, topk=50, alpha=1,
                 beta=1, net_dropout=0.0, batch_norm=False,
                 accumulation_steps=1, product_pooling=False, device=None,
                 seed=2019, **kwargs):
        # accumulation_steps is taken and dropped, as the JAX SIM does: its
        # RankModel reads the value only from kwargs, so SIM never accumulates
        super().__init__(feature_map, model_id=model_id, device=device,
                         seed=seed, **kwargs)
        if gsu_type != "soft" or product_pooling:
            raise NotImplementedError(
                "SIM is ported with gsu_type='soft' and no product pooling")
        self._alpha, self._beta = float(alpha), float(beta)
        g = self.generator
        self.short_seq_len = short_seq_len
        self.topk = topk
        self.item_dim = _field_dims(feature_map, embedding_dim, item=True)
        ctx_dim = _field_dims(feature_map, embedding_dim, item=False)
        self.embedding = FeatureEmbedding(feature_map, embedding_dim,
                                          generator=g)
        attn = dict(input_dim=self.item_dim, attention_dim=attention_dim,
                    num_heads=num_heads, dropout_rate=attention_dropout,
                    generator=g)
        self.short_attention = MultiHeadTargetAttention(**attn)
        self.W_a = Dense(self.item_dim, attention_dim, bias=False)
        self.W_b = Dense(self.item_dim, attention_dim, bias=False)
        xavier_normal_(self.W_a.weight.data, g)
        xavier_normal_(self.W_b.weight.data, g)
        mlp = dict(hidden_units=tuple(dnn_hidden_units),
                   hidden_activations=dnn_activations, output_dim=1,
                   batch_norm=batch_norm, dropout_rates=net_dropout,
                   generator=g)
        self.dnn_aux = MLP_Block(ctx_dim + 2 * self.item_dim, **mlp)
        self.long_attention = MultiHeadTargetAttention(**attn)
        self.dnn = MLP_Block(ctx_dim + 3 * self.item_dim, **mlp)
        self._finish_build()

    def forward(self, batch):
        emb_list, item_emb, mask = self._encode(batch)
        target_emb = item_emb[:, -1, :]
        # the short window holds short_seq_len-1 items and its mask sits one
        # slot earlier than its embeddings: a quirk of the reference SIM
        # that the JAX model keeps, kept here for parity
        short_seq = item_emb[:, -self.short_seq_len:-1, :]
        short_mask = mask[:, -self.short_seq_len:-1]
        short_interest = self.short_attention(target_emb, short_seq,
                                              short_mask)
        long_seq = item_emb[:, :-1, :]
        q = self.W_a(target_emb)
        kk = self.W_b(long_seq)
        # in bfloat16 the float32 mask promotes qk, pooled and the aux input
        # to float32, as jnp does; the ESU path stays bfloat16
        qk = einsum("bd,bld->bl", q, kk) * mask
        pooled = einsum("bl,bld->bd", qk, long_seq)
        y_aux = self.dnn_aux(torch.cat(emb_list + [target_emb, pooled],
                                       dim=-1))
        # top-k selects on qk after the mask multiply: padded slots score 0
        # and can outrank negative real scores (reference semantics)
        topk_emb, topk_mask = topk_gather(long_seq, mask, qk, self.topk)
        long_interest = self.long_attention(target_emb, topk_emb, topk_mask)
        y = self.dnn(torch.cat(
            emb_list + [target_emb, short_interest, long_interest], dim=-1))
        return {"y_pred": y, "y_aux": y_aux}

    def add_loss(self, outputs, y_true, weights):
        """GSU + ESU joint loss: each the mask-weighted mean of the
        per-example loss over ``sum(weights)`` (at least 1)."""
        w = weights.reshape(-1, 1)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        loss_esu = torch.sum(self._loss_fn(outputs["y_pred"], y_true) * w)
        loss_gsu = torch.sum(self._loss_fn(outputs["y_aux"], y_true) * w)
        return self._alpha * (loss_gsu / wsum) + self._beta * (loss_esu / wsum)

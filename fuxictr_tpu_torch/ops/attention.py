"""Attention layers, ported from ``fuxictr_tpu.ops.attention``.

``MultiHeadTargetAttention`` projects one target per row and its history,
splits heads, and runs single-query attention over ``[B*H, L, Dh]`` through
``ops/target_attention.py`` (the CUDA kernels on the GPU, forward and
backward). The projections are ``Dense`` products (``ops/common.py``),
named as the flax ones are. In bfloat16 the layer takes bfloat16 q, k, v
and keeps the mask float32, as the JAX layer does.
"""

import torch
from torch import nn

from fuxictr_tpu_torch.ops.common import Dense, Dropout, xavier_normal_
from fuxictr_tpu_torch.ops.target_attention import (target_attention,
                                                    target_attention_weights)


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _linear(in_dim, out_dim, generator):
    lin = Dense(in_dim, out_dim, bias=False)
    xavier_normal_(lin.weight.data, generator)
    return lin


class MultiHeadTargetAttention(nn.Module):
    """Single-query multi-head attention of a target item over its history.

    ``attention_fn`` is the attention of one query per row; it defaults to
    :func:`target_attention`, and a test may swap in another function of
    the same signature. ``dropout_rate`` drops attention weights in
    training, as the JAX layer does; the kernel has no dropout, so in
    training on CUDA a rate above 0 raises, and on the CPU the plain
    weights are dropped."""

    def __init__(self, input_dim=64, attention_dim=64, num_heads=1,
                 use_scale=True, dropout_rate=0.0, generator=None):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.att_dim = attention_dim
        self.num_heads = num_heads
        head_dim = attention_dim // num_heads
        self.scale = head_dim ** 0.5 if use_scale else 1.0
        self.attention_fn = target_attention
        self.W_q = _linear(input_dim, attention_dim, generator)
        self.W_k = _linear(input_dim, attention_dim, generator)
        self.W_v = _linear(input_dim, attention_dim, generator)
        self.W_o = _linear(attention_dim, input_dim, generator)

    def forward(self, target_item, history_sequence, mask=None):
        q = self.W_q(target_item)
        k = self.W_k(history_sequence)
        v = self.W_v(history_sequence)
        B, L, _ = k.shape
        H = self.num_heads
        dh = self.att_dim // H
        q = q.reshape(B * H, dh)
        k = _split_heads(k, H).reshape(B * H, L, dh).contiguous()
        v = _split_heads(v, H).reshape(B * H, L, dh).contiguous()
        if mask is not None:
            mask = mask.repeat_interleave(H, dim=0) if H > 1 else mask
            mask = mask.contiguous()
        if self.training and self.dropout.rate > 0:
            if q.is_cuda:
                raise NotImplementedError(
                    "attention_dropout > 0 in training: the target-attention "
                    "kernel has no dropout yet")
            attn = self.dropout(target_attention_weights(q, k, mask,
                                                         self.scale))
            out = torch.einsum("bl,bld->bd", attn, v)
        else:
            out = self.attention_fn(q.contiguous(), k, v, mask, self.scale)
        out = _merge_heads(out.reshape(B, H, 1, dh))[:, 0, :]
        return self.W_o(out)

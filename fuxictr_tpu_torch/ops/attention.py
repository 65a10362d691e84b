"""Attention layers, ported from ``fuxictr_tpu.ops.attention``.

``MultiHeadTargetAttention`` projects one target per row and its history,
splits heads, and runs single-query attention over ``[B*H, L, Dh]`` through
``ops/target_attention.py`` (the CUDA kernel on the GPU). The projections
are plain ``nn.Linear`` products, named as the flax ones are.
"""

from torch import nn

from fuxictr_tpu_torch.ops.common import xavier_normal_
from fuxictr_tpu_torch.ops.target_attention import target_attention


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _linear(in_dim, out_dim, generator):
    lin = nn.Linear(in_dim, out_dim, bias=False)
    xavier_normal_(lin.weight.data, generator)
    return lin


class MultiHeadTargetAttention(nn.Module):
    """Single-query multi-head attention of a target item over its history.

    ``attention_fn`` is the attention of one query per row; it defaults to
    :func:`target_attention`, and a test may swap in another function of
    the same signature. Attention dropout is a training feature and is not
    applied."""

    def __init__(self, input_dim=64, attention_dim=64, num_heads=1,
                 use_scale=True, generator=None):
        super().__init__()
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
        out = self.attention_fn(q.contiguous(), k, v, mask, self.scale)
        out = _merge_heads(out.reshape(B, H, 1, dh))[:, 0, :]
        return self.W_o(out)

"""Cross networks of DCNv2, ported from ``fuxictr_tpu.ops.interactions``.

Parameters keep the JAX package's names and shapes (``cross_{i}`` Dense
layers; ``U_{i}``, ``V_{i}`` ``[E, D, R]``, ``C_{i}`` ``[E, R, R]``,
``bias_{i}`` and the bias-free ``gate_{i}`` Dense of the mixture), so
converted flax parameters load by name. Products go through the port's
``Dense`` and ``einsum``, which promote mixed types as flax and jnp do.
"""

import torch
from torch import nn

from fuxictr_tpu_torch.ops.common import Dense, einsum, xavier_normal_


def _dense(in_dim, out_dim, generator, bias=True):
    layer = Dense(in_dim, out_dim, bias=bias)
    xavier_normal_(layer.weight.data, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def softmax(x, dim=-1):
    """``jax.nn.softmax`` as it is written: ``e / sum(e)`` with ``e =
    exp(x - max)`` and the max outside the gradient, each step rounded to
    the input's type."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / torch.sum(e, dim=dim, keepdim=True)


class CrossNetV2(nn.Module):
    """DCNv2's full-matrix cross: ``x_{i+1} = x_i + x_0 * (W_i x_i + b_i)``."""

    def __init__(self, input_dim, num_layers, generator=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"cross_{i}",
                            _dense(input_dim, input_dim, generator))

    def forward(self, x0):
        xi = x0
        for i in range(self.num_layers):
            xi = xi + x0 * getattr(self, f"cross_{i}")(xi)
        return xi


class CrossNetMix(nn.Module):
    """DCN-M's low-rank mixture of experts: per layer, softmax gates over
    ``E`` experts, each ``x_0 * (U_e tanh(C_e tanh(V_e^T x_l)) + b)``."""

    def __init__(self, input_dim, num_layers=2, low_rank=32, num_experts=4,
                 generator=None):
        super().__init__()
        self.num_layers = num_layers
        E, D, R = num_experts, input_dim, low_rank
        for i in range(num_layers):
            for name, shape in (("U", (E, D, R)), ("V", (E, D, R)),
                                ("C", (E, R, R))):
                weight = torch.empty(shape)
                xavier_normal_(weight, generator)
                self.register_parameter(f"{name}_{i}", nn.Parameter(weight))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros(D)))
            self.add_module(f"gate_{i}", _dense(D, E, generator, bias=False))

    def forward(self, inputs):
        x0 = xl = inputs                                        # [B, D]
        for i in range(self.num_layers):
            U, V, C, b = (getattr(self, f"{n}_{i}")
                          for n in ("U", "V", "C", "bias"))
            gates = softmax(getattr(self, f"gate_{i}")(xl))     # [B, E]
            vx = torch.tanh(einsum("bd,edr->ber", xl, V))
            vx = torch.tanh(einsum("ber,erq->beq", vx, C))
            uvx = einsum("ber,edr->bed", vx, U) + b             # [B, E, D]
            expert_out = x0[:, None, :] * uvx
            xl = xl + einsum("bed,be->bd", expert_out, gates)
        return xl

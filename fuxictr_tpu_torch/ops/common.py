"""The initializer, the activations, the regularizer grammar, dropout and
the mixed-type rules of the ported layers. Activations and regularizers
named in configs resolve through explicit parsers (never ``eval``); the
initializer and dropout draw from the ``torch.Generator`` they are given.
``Dense`` and ``einsum`` promote mixed input types as ``flax.linen.Dense``
and ``jnp.einsum`` do, where torch's ``F.linear`` and ``einsum`` refuse
them: a bfloat16 model meets float32 masks (``models/base.py``)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

# jax.nn.initializers' truncated normal is cut at two standard deviations
# and rescaled by this factor so that its variance is the one asked for
_TRUNC_STD = 0.87962566103423978


def xavier_normal_(tensor, generator):
    """In place: ``jax.nn.initializers.glorot_normal`` (fan-average variance
    scaling, truncated normal) for a 2-D ``[out, in]`` weight, or for a
    parameter of three or more dims kept in flax's layout ``[..., in,
    out]``, whose fans are multiplied by the leading dims (flax's receptive
    field: ``[E, D, R]`` has fan_in ``D*E`` and fan_out ``R*E``)."""
    if tensor.dim() == 2:
        fan_out, fan_in = tensor.shape
    else:
        field = math.prod(tensor.shape[:-2])
        fan_in, fan_out = (field * n for n in tensor.shape[-2:])
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std,
                                       2.0 * std, generator=generator)


def get_regularizer(reg):
    """A regularizer spec as ``[(p_norm, weight)]``, the grammar of
    ``fuxictr_tpu.ops.common.get_regularizer``: a number is an L2 weight
    (0 is none), ``"l1(x)"``, ``"l2(x)"``, ``"l1_l2(x,y)"``; ``None`` is
    none. Anything else raises."""
    reg_pair = []
    if isinstance(reg, (int, float)):
        if reg != 0:
            reg_pair.append((2, float(reg)))
    elif isinstance(reg, str):
        if reg.startswith("l1(") or reg.startswith("l2("):
            reg_pair.append((int(reg[1]),
                             float(reg.rstrip(")").split("(")[-1])))
        elif reg.startswith("l1_l2"):
            l1_reg, l2_reg = reg.rstrip(")").split("(")[-1].split(",")
            reg_pair.append((1, float(l1_reg)))
            reg_pair.append((2, float(l2_reg)))
        else:
            raise NotImplementedError(f"regularizer={reg} is not supported.")
    elif reg is not None:
        raise NotImplementedError(f"regularizer={reg} is not supported.")
    return reg_pair


class Dropout(nn.Module):
    """``flax.linen.Dropout`` in training: each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed;
    the identity in eval mode or at rate 0. The keep mask draws from
    ``generator`` (on the input's device), which the model sets
    (``RankModel``); its stream is torch's, not JAX's."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


_ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "elu": F.elu,
    "selu": F.selu,
    "silu": F.silu,
    "swish": F.silu,
    "softplus": F.softplus,
    "leakyrelu": F.leaky_relu,
    "leaky_relu": F.leaky_relu,
    "identity": lambda x: x,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def get_activation(name):
    """Stateless activation by config name (case-insensitive; ``None`` is
    the identity). Parametric ones (``dice``, ``prelu``) are not ported
    yet."""
    key = (name or "none").lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"activation={name} is not supported.")
    return _ACTIVATIONS[key]


def einsum(equation, *operands):
    """``torch.einsum`` on operands promoted to their common type, as
    ``jnp.einsum`` promotes them (bfloat16 with float32 gives float32)."""
    dtype = operands[0].dtype
    for op in operands[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    return torch.einsum(equation, *(op.to(dtype) for op in operands))


class Dense(nn.Linear):
    """``nn.Linear`` that computes in the common type of its input and its
    parameters, as ``flax.linen.Dense`` (``dtype=None``) does: a float32
    input to bfloat16 parameters gives a float32 product. The bias is added
    after the product, as there, so that bfloat16 rounds twice."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)

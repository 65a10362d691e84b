"""The initializer and the activations of the ported layers. Activations
named in configs resolve through an explicit table (never ``eval``); the
initializer draws from the ``torch.Generator`` it is given."""

import math

import torch
import torch.nn.functional as F

# jax.nn.initializers' truncated normal is cut at two standard deviations
# and rescaled by this factor so that its variance is the one asked for
_TRUNC_STD = 0.87962566103423978


def xavier_normal_(tensor, generator):
    """In place: ``jax.nn.initializers.glorot_normal`` (fan-average variance
    scaling, truncated normal) for a 2-D ``[out, in]`` weight."""
    fan_out, fan_in = tensor.shape
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std,
                                       2.0 * std, generator=generator)


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

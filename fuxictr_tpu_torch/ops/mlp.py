"""MLP tower, ported from ``fuxictr_tpu.ops.mlp.MLP_Block``.

Layer order as there: Linear -> BatchNorm (optional) -> activation ->
dropout, then an optional output Linear. Submodules are named like flax's
auto-names (``Dense_{i}``, ``BatchNorm_{i}``) so converted parameters land
by name. BatchNorm is written in ``flax.linen.BatchNorm(momentum=0.9)``'s
form, not torch's: in training it normalizes by the batch's mean and
*biased* variance over every row (the rows that pad the last batch too, as
in JAX) and moves the running statistics by ``0.9 * old + 0.1 * batch``;
in eval mode it uses the running statistics. Statistics are float32
whatever the input type, with flax's type rules for the result.
"""

from typing import Sequence, Union

import torch
from torch import nn

from fuxictr_tpu_torch.ops.common import (Dense, Dropout, get_activation,
                                          xavier_normal_)

# flax.linen.BatchNorm's default epsilon, and the momentum the JAX
# MLP_Block gives it
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9


def _batch_norm(x, bn, training):
    """``flax.linen.BatchNorm``: ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias``, cast to the common type of ``x``, scale and bias (bfloat16
    when all three are). In training, mean and variance are the float32
    batch statistics over axis 0 (``E[x^2] - E[x]^2``, clipped at 0, as
    flax's fast variance), and the running statistics move towards them in
    place; else the running statistics are used."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, bn.weight.dtype),
                                bn.bias.dtype)
    if training:
        x32 = x.float()
        mean = x32.mean(dim=0)
        var = torch.clamp((x32 * x32).mean(dim=0) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean
                                  + (1 - _BN_MOMENTUM) * mean)
            bn.running_var.copy_(_BN_MOMENTUM * bn.running_var
                                 + (1 - _BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean) * mul + bn.bias).to(dtype)


class MLP_Block(nn.Module):

    def __init__(self, input_dim, hidden_units: Sequence[int] = (),
                 hidden_activations: Union[str, Sequence[str]] = "relu",
                 output_dim=None, batch_norm=False, dropout_rates=0.0,
                 generator=None):
        super().__init__()
        n = len(hidden_units)
        acts = hidden_activations
        if not isinstance(acts, (list, tuple)):
            acts = [acts] * n
        self._acts = [get_activation(a) for a in acts]
        rates = dropout_rates
        if not isinstance(rates, (list, tuple)):
            rates = [rates] * n
        for i, rate in enumerate(rates):
            if rate > 0:
                self.add_module(f"Dropout_{i}", Dropout(rate))
        self._batch_norm = batch_norm
        dims = [input_dim] + list(hidden_units)
        if output_dim is not None:
            dims.append(output_dim)
        for i in range(len(dims) - 1):
            lin = Dense(dims[i], dims[i + 1])
            xavier_normal_(lin.weight.data, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"Dense_{i}", lin)
        if batch_norm:
            for i, units in enumerate(hidden_units):
                self.add_module(f"BatchNorm_{i}",
                                nn.BatchNorm1d(units, eps=_BN_EPS))
        self._n_hidden = n
        self._has_output = output_dim is not None

    def forward(self, x):
        for i in range(self._n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self._batch_norm:
                x = _batch_norm(x, getattr(self, f"BatchNorm_{i}"),
                                self.training)
            x = self._acts[i](x)
            if hasattr(self, f"Dropout_{i}"):
                x = getattr(self, f"Dropout_{i}")(x)
        if self._has_output:
            x = getattr(self, f"Dense_{self._n_hidden}")(x)
        return x

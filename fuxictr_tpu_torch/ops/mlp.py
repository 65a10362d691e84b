"""MLP tower, ported from ``fuxictr_tpu.ops.mlp.MLP_Block`` for inference.

Layer order as there: Linear -> BatchNorm (optional) -> activation, then
an optional output Linear. Submodules are named like flax's
auto-names (``Dense_{i}``, ``BatchNorm_{i}``) so converted parameters land
by name. Dropout is an identity at inference and is not built; BatchNorm
runs in eval form on its running statistics, with flax's type rules.
"""

from typing import Sequence, Union

import torch
from torch import nn

from fuxictr_tpu_torch.ops.common import (Dense, get_activation,
                                          xavier_normal_)

# flax.linen.BatchNorm's default epsilon
_BN_EPS = 1e-5


def _batch_norm_eval(x, bn):
    """``flax.linen.BatchNorm`` at inference: ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` against the float32 running statistics, cast to
    the common type of ``x``, scale and bias (bfloat16 when all three
    are)."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, bn.weight.dtype),
                                bn.bias.dtype)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x - bn.running_mean) * mul + bn.bias).to(dtype)


class MLP_Block(nn.Module):

    def __init__(self, input_dim, hidden_units: Sequence[int] = (),
                 hidden_activations: Union[str, Sequence[str]] = "relu",
                 output_dim=None, batch_norm=False, generator=None):
        super().__init__()
        n = len(hidden_units)
        acts = hidden_activations
        if not isinstance(acts, (list, tuple)):
            acts = [acts] * n
        self._acts = [get_activation(a) for a in acts]
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
                x = _batch_norm_eval(x, getattr(self, f"BatchNorm_{i}"))
            x = self._acts[i](x)
        if self._has_output:
            x = getattr(self, f"Dense_{self._n_hidden}")(x)
        return x

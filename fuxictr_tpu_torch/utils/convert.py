"""Parameters of a ``fuxictr_tpu`` model as a state dict of the port.

The input is numpy only, as ``jax.device_get(model.state.params)`` gives
it: nested dicts of arrays keyed by flax module names. The port names its
modules as flax does, so a flax path maps to a state-dict key by joining
it with dots, and only the leaves change:

- a ``Dense`` ``kernel`` ``[in, out]`` becomes ``nn.Linear.weight``
  ``[out, in]`` (transposed); ``bias`` stays;
- a ``BatchNorm`` ``scale`` becomes ``weight``, and its ``batch_stats``
  ``mean`` / ``var`` become ``running_mean`` / ``running_var``;
- fused embedding tables (``table_d{dim}[b{k}]``) and numeric weights
  (``numeric_d{dim}``) copy as they are, since the port keeps the fused
  layout; so do the parameters a module declares itself, such as
  ``CrossNetMix``'s ``[E, D, R]`` ``U_{i}`` / ``V_{i}``, ``C_{i}`` and
  ``bias_{i}`` and the LR bias.

So ``fm/lr/embedding/table_d1`` becomes ``fm.lr.embedding.table_d1`` and
``crossnet/gate_0/kernel`` ``crossnet.gate_0.weight``, transposed. Only a
2-D ``kernel`` is taken: a stacked one (``stacked_mlp``) raises.
"""

from collections import OrderedDict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def params_from_jax(params, batch_stats=None):
    """``params`` (and the ``batch_stats`` collection, if the model has
    BatchNorm) of a flax model -> a state dict for ``load_state_dict``."""
    state = OrderedDict()
    for path, arr in _flatten(params):
        *mod, leaf = path
        if leaf == "kernel":
            if arr.ndim != 2:
                raise NotImplementedError(
                    f"{'/'.join(path)}: a {arr.ndim}-D kernel (stacked "
                    f"Dense) is not ported")
            arr, leaf = arr.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        state[".".join(mod + [leaf])] = torch.tensor(arr)
    for path, arr in _flatten(batch_stats or {}):
        *mod, leaf = path
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
        state[".".join(mod + [leaf])] = torch.tensor(arr)
        state[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return state

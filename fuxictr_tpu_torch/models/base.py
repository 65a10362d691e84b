"""Inference half of ``fuxictr_tpu.models.base.RankModel``.

A model is an ``nn.Module`` built on one device, with its random init drawn
from a seeded ``torch.Generator``. ``predict`` and ``evaluate`` run it in
eval mode under ``torch.no_grad()`` over a loader of numpy batches: each
batch moves to the device, the logits go through a sigmoid (binary
classification), and the rows that pad the last batch are dropped by the
sample mask before any metric sees them. Training, and tasks other than
binary classification, are not ported yet.

``compute_dtype`` follows the JAX package's ``_predict_body``: the
parameters stay float32 (the state ``load_state_dict`` fills), the forward
runs on a copy of every floating parameter cast to the compute type, and
the logits are cast to float32 before the sigmoid. Batch tensors keep their
types, so a float32 mask promotes what it touches, as in jnp. There is no
autocast: each op computes in the type its inputs give it.
"""

import logging

import numpy as np
import torch
from torch import nn

from fuxictr_tpu_torch import resolve_device
from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.metrics import evaluate_metrics

# compute_dtype values, as the JAX package reads them (models/base.py there);
# float16 and float64 are refused: the port's kernels take float32 and
# bfloat16 only
_FLOAT32_NAMES = (None, "float32", "fp32")
_BFLOAT16_NAMES = ("bfloat16", "bf16")


def resolve_compute_dtype(value):
    """``None`` for float32 compute, else ``torch.bfloat16``. Raises on any
    value the port cannot honour."""
    if value in _FLOAT32_NAMES or value is torch.float32:
        return None
    if value in _BFLOAT16_NAMES or value is torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"compute_dtype={value!r} is not supported: use "
                     f"float32 / fp32 / None, or bfloat16 / bf16")


class RankModel(nn.Module):
    """Subclasses build their layers in ``__init__`` (on the CPU, from
    ``self.generator``), then call :meth:`_finish_build`, and implement
    ``forward(batch) -> {"y_pred": logits, ...}``."""

    def __init__(self, feature_map, model_id="RankModel",
                 task="binary_classification", device=None, seed=2019,
                 compute_dtype=None, **kwargs):
        super().__init__()
        if task != "binary_classification":
            raise NotImplementedError(f"task={task} is not ported yet")
        self.feature_map = feature_map
        self.model_id = model_id
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.validation_metrics = kwargs.get("metrics", ["AUC"])
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self._cast_params, self._cast_key = None, None

    def _finish_build(self):
        self.to(self.device)
        self.eval()

    def train(self, mode=True):
        if mode:
            raise NotImplementedError("training is not ported yet")
        return super().train(False)

    def _place_batch(self, batch):
        out = {}
        for key, val in batch.items():
            if isinstance(val, dict):
                out[key] = self._place_batch(val)
            else:
                out[key] = torch.as_tensor(np.asarray(val),
                                           device=self.device)
        return out

    def _compute_params(self):
        """Every floating parameter cast to the compute type. The copy is
        made once and again only after a parameter was replaced or changed
        in place (``load_state_dict``, ``to``), which its version counter
        and address show."""
        key = tuple((p.device, p.data_ptr(), p._version)
                    for p in self.parameters())
        if key != self._cast_key:
            self._cast_params = {
                name: (p.detach().to(self.compute_dtype)
                       if p.is_floating_point() else p.detach())
                for name, p in self.named_parameters()}
            self._cast_key = key
        return self._cast_params

    def compute_forward(self, batch):
        """The forward of a batch already on the device, in the compute
        type: ``self(batch)`` in float32, else the same forward on the cast
        parameters (buffers such as BatchNorm statistics stay float32)."""
        if self.compute_dtype is None:
            return self(batch)
        return torch.func.functional_call(self, self._compute_params(),
                                          (batch,))

    def _predict_batch(self, batch):
        y = self.compute_forward(self._place_batch(batch))["y_pred"].float()
        return torch.sigmoid(y).cpu().numpy()

    @torch.no_grad()
    def _predictions(self, data_generator):
        """Predictions and labels of the real rows, in loader order."""
        label = self.feature_map.labels[0]
        preds, labels = [], []
        for batch in data_generator:
            m = np.asarray(batch[SAMPLE_MASK_KEY]) > 0
            preds.append(self._predict_batch(batch).reshape(len(m), -1)[m])
            if label in batch:
                labels.append(np.asarray(batch[label]).reshape(len(m))[m])
        y_true = np.concatenate(labels) if labels else None
        return np.concatenate(preds), y_true

    def predict(self, data_generator):
        """Predicted probabilities of the real rows, float64."""
        y_pred, _ = self._predictions(data_generator)
        return y_pred.reshape(-1).astype(np.float64)

    def evaluate(self, data_generator, metrics=None):
        """Metrics (``AUC``, ``logloss``) over the real rows."""
        y_pred, y_true = self._predictions(data_generator)
        if y_true is None:
            raise ValueError(f"the batches carry no label column "
                             f"{self.feature_map.labels[0]!r}")
        logs = evaluate_metrics(y_true.astype(np.float64),
                                y_pred.reshape(-1).astype(np.float64),
                                metrics or self.validation_metrics)
        logging.info("[Metrics] " + " - ".join(
            f"{k}: {v:.6f}" for k, v in logs.items()))
        return logs

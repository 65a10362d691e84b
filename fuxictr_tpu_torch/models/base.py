"""Inference half of ``fuxictr_tpu.models.base.RankModel``.

A model is an ``nn.Module`` built on one device, with its random init drawn
from a seeded ``torch.Generator``. ``predict`` and ``evaluate`` run it in
eval mode under ``torch.no_grad()`` over a loader of numpy batches: each
batch moves to the device, the logits go through a sigmoid (binary
classification), and the rows that pad the last batch are dropped by the
sample mask before any metric sees them. Training, and tasks other than
binary classification, are not ported yet.
"""

import logging

import numpy as np
import torch
from torch import nn

from fuxictr_tpu_torch import resolve_device
from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.metrics import evaluate_metrics


class RankModel(nn.Module):
    """Subclasses build their layers in ``__init__`` (on the CPU, from
    ``self.generator``), then call :meth:`_finish_build`, and implement
    ``forward(batch) -> {"y_pred": logits, ...}``."""

    def __init__(self, feature_map, model_id="RankModel",
                 task="binary_classification", device=None, seed=2019,
                 **kwargs):
        super().__init__()
        if task != "binary_classification":
            raise NotImplementedError(f"task={task} is not ported yet")
        self.feature_map = feature_map
        self.model_id = model_id
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.validation_metrics = kwargs.get("metrics", ["AUC"])

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

    def _predict_batch(self, batch):
        y = self(self._place_batch(batch))["y_pred"].float()
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

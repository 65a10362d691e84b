"""Evaluation metrics without scikit-learn.

``AUC`` is the Mann-Whitney U statistic with average ranks over tied
scores, which equals sklearn's trapezoidal ``roc_auc_score`` exactly (the
equivalence ``fuxictr_tpu.metrics`` documents and uses on device).
``logloss`` follows sklearn's ``log_loss`` on binary labels: the
probabilities of both classes, ``p`` and ``1 - p``, are clipped to
``[eps, 1 - eps]`` with the float64 machine epsilon.
"""

from collections import OrderedDict

import numpy as np
from scipy.special import xlogy
from scipy.stats import rankdata


def roc_auc(y_true, y_pred):
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    pos = y_true > 0.5
    n_pos = int(pos.sum())
    n_neg = y_true.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC is undefined when y_true holds one class")
    ranks = rankdata(np.asarray(y_pred, np.float64).reshape(-1),
                     method="average")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def log_loss(y_true, y_pred):
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    p = np.asarray(y_pred, np.float64).reshape(-1)
    eps = np.finfo(np.float64).eps
    loss = -(xlogy(y_true, np.clip(p, eps, 1 - eps))
             + xlogy(1.0 - y_true, np.clip(1.0 - p, eps, 1 - eps)))
    return float(loss.mean())


_METRICS = {"AUC": roc_auc, "logloss": log_loss,
            "binary_crossentropy": log_loss}


def evaluate_metrics(y_true, y_pred, metrics):
    """OrderedDict of the requested metrics; grouped metrics (gAUC, MRR,
    NDCG) are not ported yet."""
    out = OrderedDict()
    for metric in metrics:
        if metric not in _METRICS:
            raise ValueError(f"metric={metric} not supported.")
        out[metric] = _METRICS[metric](y_true, y_pred)
    return out

"""``fuxictr_tpu.models.base.RankModel``: training and inference.

A model is an ``nn.Module`` built on one device, with its random init drawn
from a seeded ``torch.Generator`` (and its dropout from a second one on the
device). ``predict`` and ``evaluate`` run it in eval mode under
``torch.no_grad()`` over a loader of numpy batches: each batch moves to the
device, the logits go through a sigmoid (binary classification), and the
rows that pad the last batch are dropped by the sample mask before any
metric sees them. Tasks other than binary classification are not ported.

Training follows the JAX package's runtime: ``fit`` -> ``train_epoch`` ->
``train_step``, evaluation every ``eval_steps`` (default: once per epoch)
on the monitored metrics, early stop after ``early_stop_patience``
evaluations without a gain of 1e-6, the learning rate times 0.1 on each
plateau (floor 1e-6), the best weights saved and reloaded at the end. The
loss is optax's sigmoid BCE on the logits, weighted by the sample mask and
divided by its sum (at least 1), plus the p-norm regularizers split by
module (``FeatureEmbedding`` parameters take ``embedding_regularizer``, the
rest ``net_regularizer``). The optimizer is optax's chain of
``clip_by_global_norm(max_gradient_norm)`` and Adam with an injectable
learning rate, written out in float32 (:class:`ClippedAdam`). Weights are
saved as a torch state dict to ``<model_root>/<dataset_id>/<model_id>.pt``,
a path the JAX package never writes.

``compute_dtype`` follows the JAX package's ``_predict_body`` and train
step: the parameters stay float32 (the state ``load_state_dict`` fills and
the optimizer updates), the forward runs on every floating parameter cast
to the compute type, and the outputs are cast to float32 before the
sigmoid or the loss. Serving keeps one detached cast copy; training casts
inside the autograd graph on every step, so that the gradients reach the
float32 masters, where the optimizer state stays. Batch tensors keep their
types, so a float32 mask promotes what it touches, as in jnp. There is no
autocast: each op computes in the type its inputs give it.

Not ported yet (they raise): other optimizers, ``accumulation_steps > 1``,
``lazy_adam``, ``periodic_ckpt``.
"""

import logging
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fuxictr_tpu_torch import resolve_device
from fuxictr_tpu_torch.config import Monitor
from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.metrics import evaluate_metrics
from fuxictr_tpu_torch.ops.common import Dropout, get_regularizer
from fuxictr_tpu_torch.ops.embedding import FeatureEmbedding

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


def seed_everything(seed=2019):
    """Seed numpy's global generator, as the JAX package's
    ``seed_everything`` does. The port's own draws (init, dropout,
    shuffling) take explicit generators seeded from the same number."""
    np.random.seed(seed)


def sigmoid_binary_cross_entropy(logits, labels):
    """Per-example BCE on logits in optax's form:
    ``-labels * log_sigmoid(x) - (1 - labels) * log_sigmoid(-x)``."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def make_loss_fn(loss):
    """Config loss name -> per-example loss on logits; the port takes the
    binary cross-entropy names only."""
    if str(loss).lower() in ("bce", "binary_crossentropy",
                             "binary_cross_entropy"):
        return sigmoid_binary_cross_entropy
    raise NotImplementedError(f"loss={loss} is not ported yet")


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm),
    inject_hyperparams(adam)(learning_rate))`` over a list of float32
    parameters, written out as optax computes it, in float32:

    - clip: ``g_norm = sqrt(sum of g^2 over all leaves)``; each gradient is
      kept when ``g_norm < max_norm``, else ``g / g_norm * max_norm``;
    - adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, one
      step count for all leaves, ``mu_hat = mu / (1 - b1^count)`` (and
      ``nu_hat`` alike), update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``
      added to the parameter in place.

    ``lr`` is a float32 number that ``lr_decay`` may change between
    steps, as the injected hyperparameter in the JAX package's state."""

    def __init__(self, params, lr, max_gradient_norm=10.0):
        self.params = list(params)
        self.lr = np.float32(lr)
        self.max_gradient_norm = float(max_gradient_norm)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        grads = [g.float() for g in grads]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_gradient_norm
        self.count += 1
        bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(self.count))
        step_size = -float(self.lr)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, g / g_norm * self.max_gradient_norm)
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            p.add_(update * step_size)


class RankModel(nn.Module):
    """Subclasses build their layers in ``__init__`` (on the CPU, from
    ``self.generator``), then call :meth:`_finish_build`, and implement
    ``forward(batch) -> {"y_pred": logits, ...}``."""

    def __init__(self, feature_map, model_id="RankModel",
                 task="binary_classification", device=None, seed=2019,
                 compute_dtype=None, monitor="AUC", save_best_only=True,
                 monitor_mode="max", early_stop_patience=2, eval_steps=None,
                 embedding_regularizer=None, net_regularizer=None,
                 reduce_lr_on_plateau=True, learning_rate=1e-3,
                 optimizer="adam", loss="binary_crossentropy",
                 model_root="./checkpoints", **kwargs):
        super().__init__()
        if task != "binary_classification":
            raise NotImplementedError(f"task={task} is not ported yet")
        if "table_size_buckets" in kwargs:
            # read by every FeatureEmbedding of the model, as in JAX
            feature_map.table_size_buckets = kwargs["table_size_buckets"]
        self.feature_map = feature_map
        self.model_id = model_id
        self.device = resolve_device(device)
        self._seed = int(seed)
        seed_everything(self._seed)
        self.generator = torch.Generator().manual_seed(self._seed)
        self.validation_metrics = kwargs.get("metrics", ["AUC"])
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self._cast_params, self._cast_key = None, None
        self._monitor = Monitor(kv=monitor)
        self._monitor_mode = monitor_mode
        self._early_stop_patience = early_stop_patience
        self._eval_steps_user = eval_steps
        self._save_best_only = save_best_only
        self._emb_reg = get_regularizer(embedding_regularizer)
        self._net_reg = get_regularizer(net_regularizer)
        self._reduce_lr_on_plateau = reduce_lr_on_plateau
        self._learning_rate = learning_rate
        self._optimizer_name = optimizer
        self._loss_fn = make_loss_fn(loss)
        self._optimizer = None
        self._resume_step = 0
        self.kwargs = kwargs
        self.model_dir = os.path.join(model_root, feature_map.dataset_id)
        self.checkpoint = os.path.abspath(
            os.path.join(self.model_dir, f"{model_id}.pt"))

    def _finish_build(self):
        self.to(self.device)
        self.eval()
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(self._seed)
        for module in self.modules():
            if isinstance(module, Dropout):
                module.generator = self.dropout_generator

    def _place_batch(self, batch):
        """A loader batch (numpy) on the model's device; tensors already
        there pass through."""
        out = {}
        for key, val in batch.items():
            if isinstance(val, dict):
                out[key] = self._place_batch(val)
            else:
                out[key] = torch.as_tensor(
                    val if torch.is_tensor(val) else np.asarray(val),
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
        self.eval()
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

    # ------------------------------------------------------------ training
    def _ensure_optimizer(self, max_gradient_norm=None):
        """Build the optimizer on first use (clip at 10 unless
        ``max_gradient_norm`` says otherwise), or set a new clip norm (the
        Adam state stays, as the JAX package keeps ``opt_state``). Raises
        on what is not ported."""
        for key in ("lazy_adam", "periodic_ckpt"):
            if self.kwargs.get(key):
                raise NotImplementedError(f"{key} is not ported yet")
        if int(self.kwargs.get("accumulation_steps", 1) or 1) > 1:
            raise NotImplementedError(
                "accumulation_steps > 1 (optax.MultiSteps) is not ported yet")
        if str(self._optimizer_name).lower() != "adam":
            raise NotImplementedError(
                f"optimizer={self._optimizer_name} is not ported yet: adam "
                f"only")
        if self._optimizer is None:
            self._optimizer = ClippedAdam(self.parameters(),
                                          self._learning_rate)
        if max_gradient_norm is not None:
            self._optimizer.max_gradient_norm = float(max_gradient_norm)

    @property
    def learning_rate(self):
        """The optimizer's current learning rate (float32)."""
        return (self._optimizer.lr if self._optimizer is not None
                else np.float32(self._learning_rate))

    def _embedding_param_names(self):
        return {f"{prefix}.{name}" if prefix else name
                for prefix, module in self.named_modules()
                if isinstance(module, FeatureEmbedding)
                for name, _ in module.named_parameters()}

    def regularization_loss(self):
        """``sum (lambda / p) * sum(|w|^p)`` over the float32 parameters:
        ``embedding_regularizer`` on those of ``FeatureEmbedding`` modules,
        ``net_regularizer`` on the rest."""
        if not self._emb_reg and not self._net_reg:
            return 0.0
        emb_names = self._embedding_param_names()
        reg = 0.0
        for name, param in self.named_parameters():
            pairs = self._emb_reg if name in emb_names else self._net_reg
            for p, lam in pairs:
                reg = reg + (lam / p) * torch.sum(torch.abs(param) ** p)
        return reg

    def add_loss(self, outputs, y_true, weights):
        """The loss of a batch: per-example loss weighted by the sample
        mask, divided by its sum (at least 1), plus ``aux_loss``."""
        w = weights.reshape(-1, 1)
        loss = (torch.sum(self._loss_fn(outputs["y_pred"], y_true) * w)
                / torch.clamp(torch.sum(w), min=1.0))
        if "aux_loss" in outputs:
            loss = loss + outputs["aux_loss"]
        return loss

    def _train_forward(self, batch):
        """The training forward of a placed batch, outputs in float32. In
        bf16 compute the parameters are cast inside the graph."""
        if self.compute_dtype is None:
            return self(batch)
        cast = {name: (p.to(self.compute_dtype) if p.is_floating_point()
                       else p)
                for name, p in self.named_parameters()}
        outputs = torch.func.functional_call(self, cast, (batch,))
        return {k: v.float() for k, v in outputs.items()}

    def loss_and_grads(self, batch):
        """The training loss of a batch (forward in train mode, loss plus
        regularizers) and its gradient for every parameter, in
        ``parameters()`` order; nothing is updated but BatchNorm's running
        statistics."""
        self._ensure_optimizer()
        self.train()
        placed = self._place_batch(batch)
        y_true = placed[self.feature_map.labels[0]].reshape(-1, 1)
        outputs = self._train_forward(placed)
        loss = (self.add_loss(outputs, y_true, placed[SAMPLE_MASK_KEY])
                + self.regularization_loss())
        grads = torch.autograd.grad(loss, self._optimizer.params,
                                    materialize_grads=True)
        return loss.detach(), grads

    def train_step(self, batch):
        """One optimizer step on a loader batch (numpy, or already on the
        device): :meth:`loss_and_grads`, then clip and Adam. Returns the
        loss as a 0-d float32 tensor on the device (reading it waits for
        the device)."""
        loss, grads = self.loss_and_grads(batch)
        self._optimizer.step(grads)
        return loss

    def multi_step(self, batches):
        """K train steps, in order, over a flat batch dict stacked to ``[K,
        B, ...]`` (numpy, or tensors already on the device), as the JAX
        package's ``_make_multi_step`` scans them; returns the mean of the
        K losses as a 0-d float32 tensor on the device."""
        losses = [self.train_step({k: v[i] for k, v in batches.items()})
                  for i in range(len(batches[SAMPLE_MASK_KEY]))]
        return torch.stack(losses).mean()

    def fit(self, data_generator, epochs=1, validation_data=None,
            max_gradient_norm=10.0, **kwargs):
        """Train for ``epochs`` over ``data_generator`` (re-iterated each
        epoch), evaluating ``validation_data`` every ``eval_steps`` steps;
        then reload the best weights if they were saved."""
        self._window_rates = []
        self.valid_gen = validation_data
        self._ensure_optimizer(max_gradient_norm)
        self._best_metric = (np.inf if self._monitor_mode == "min"
                             else -np.inf)
        self._stopping_steps = 0
        self._stop_training = False
        self._steps_per_epoch = len(data_generator)
        self._total_steps = self._resume_step
        self._batch_index = 0
        self._epoch_index = 0
        self._eval_steps = self._eval_steps_user or self._steps_per_epoch
        logging.info("Start training: %d batches/epoch",
                     self._steps_per_epoch)
        for epoch in range(epochs):
            self._epoch_index = epoch
            logging.info("************ Epoch=%d start ************",
                         epoch + 1)
            self.train_epoch(data_generator)
            if self._stop_training:
                break
            logging.info("************ Epoch=%d end ************", epoch + 1)
        logging.info("Training finished.")
        self._resume_step = self._total_steps    # consecutive fits continue
        if os.path.exists(self.checkpoint):
            logging.info("Load best model: %s", self.checkpoint)
            self.load_weights(self.checkpoint)

    def train_epoch(self, data_generator):
        """One pass over the loader, one step per batch (``steps_per_call``
        steps of the JAX package's scan are these steps one by one)."""
        self._batch_index = 0
        pending_losses = []
        window_start = time.perf_counter()
        window_examples = 0
        for batch_index, batch in enumerate(data_generator):
            self._batch_index = batch_index
            self._total_steps += 1
            pending_losses.append(self.train_step(batch))
            window_examples += int(
                (np.asarray(batch[SAMPLE_MASK_KEY]) > 0).sum())
            if self._total_steps % self._eval_steps == 0:
                train_loss = float(torch.stack(pending_losses).mean())
                pending_losses = []
                dt = max(time.perf_counter() - window_start, 1e-9)
                self._window_rates.append(window_examples / dt)
                logging.info("Train loss: %.6f (%.0f examples/s)",
                             train_loss, window_examples / dt)
                self.eval_step()
                window_start = time.perf_counter()
                window_examples = 0
            if self._stop_training:
                break

    def eval_step(self):
        if self.valid_gen is None:
            return
        logging.info("Evaluation @epoch %d - batch %d:",
                     self._epoch_index + 1, self._batch_index + 1)
        logs = self.evaluate(self.valid_gen,
                             metrics=self._monitor.get_metrics())
        self.checkpoint_and_earlystop(logs)

    def checkpoint_and_earlystop(self, logs, min_delta=1e-6):
        monitor_value = self._monitor.get_value(logs)
        if (self._monitor_mode == "min"
                and monitor_value > self._best_metric - min_delta) or \
           (self._monitor_mode == "max"
                and monitor_value < self._best_metric + min_delta):
            self._stopping_steps += 1
            logging.info("Monitor(%s)=%.6f STOP!", self._monitor_mode,
                         monitor_value)
            if self._reduce_lr_on_plateau:
                lr = self.lr_decay()
                logging.info("Reduce learning rate on plateau: %.6f", lr)
        else:
            self._stopping_steps = 0
            self._best_metric = monitor_value
            if self._save_best_only:
                logging.info("Save best model: monitor(%s)=%.6f",
                             self._monitor_mode, monitor_value)
                self.save_weights(self.checkpoint)
        if self._stopping_steps >= self._early_stop_patience:
            self._stop_training = True
            logging.info("********* Epoch=%d early stop *********",
                         self._epoch_index + 1)
        if not self._save_best_only:
            self.save_weights(self.checkpoint)

    def lr_decay(self, factor=0.1, min_lr=1e-6):
        """Scale the learning rate by ``factor``, at least ``min_lr``, kept
        as float32; returns the new rate."""
        self._ensure_optimizer()
        new_lr = max(float(self._optimizer.lr) * factor, min_lr)
        self._optimizer.lr = np.float32(new_lr)
        return new_lr

    def save_weights(self, checkpoint):
        """The parameters and buffers (BatchNorm statistics) as a torch
        state dict."""
        os.makedirs(os.path.dirname(checkpoint), exist_ok=True)
        torch.save(self.state_dict(), checkpoint)

    def load_weights(self, checkpoint):
        self.load_state_dict(torch.load(checkpoint, map_location=self.device,
                                        weights_only=True))

"""Config loading, the two-file YAML layout of ``fuxictr_tpu.config``, the
run's logger and its printers, and the early-stop ``Monitor``.

``model_config.yaml`` holds a ``Base`` section merged under each expid
section (the expid wins); ``dataset_config.yaml`` is keyed by dataset_id.
``yaml`` is imported inside the readers, so importing this module needs no
PyYAML.
"""

import glob
import json
import logging
import os
from collections import OrderedDict


def _read_yaml(path):
    import yaml
    with open(path, "r") as fd:
        return yaml.safe_load(fd)


def load_config(config_dir, experiment_id):
    """Merged model + dataset params for an experiment id."""
    params = load_model_config(config_dir, experiment_id)
    params.update(load_dataset_config(config_dir, params["dataset_id"]))
    return params


def load_model_config(config_dir, experiment_id):
    """``model_config.yaml`` (or ``model_config/*.yaml``): the ``Base``
    section merged with the expid section, expid winning on conflict."""
    model_configs = glob.glob(os.path.join(config_dir, "model_config.yaml"))
    if not model_configs:
        model_configs = sorted(glob.glob(
            os.path.join(config_dir, "model_config/*.yaml")))
    if not model_configs:
        raise RuntimeError(f"config_dir={config_dir} is not valid!")
    found = {}
    for config in model_configs:
        cfg = _read_yaml(config)
        if "Base" in cfg:
            found["Base"] = cfg["Base"]
        if experiment_id in cfg:
            found[experiment_id] = cfg[experiment_id]
        if len(found) == 2:
            break
    params = dict(found.get("Base", {}))
    params.update(found.get(experiment_id, {}))
    if "dataset_id" not in params:
        raise RuntimeError(f"expid={experiment_id} is not valid in config.")
    params["model_id"] = experiment_id
    return params


def load_dataset_config(config_dir, dataset_id):
    """The dataset section keyed by ``dataset_id``."""
    params = {"dataset_id": dataset_id}
    dataset_configs = glob.glob(
        os.path.join(config_dir, "dataset_config.yaml"))
    if not dataset_configs:
        dataset_configs = sorted(glob.glob(
            os.path.join(config_dir, "dataset_config/*.yaml")))
    for config in dataset_configs:
        cfg = _read_yaml(config)
        if dataset_id in cfg:
            params.update(cfg[dataset_id])
            return params
    raise RuntimeError(f"dataset_id={dataset_id} is not found in config.")


def set_logger(params, stream=True):
    """Log the run at INFO to ``<model_root>/<dataset_id>/<model_id>.log``
    (rewritten) and, with ``stream``, to stderr, replacing the root
    logger's handlers; the first line names the port and its version."""
    log_dir = os.path.join(params.get("model_root", "./checkpoints"),
                           params["dataset_id"])
    os.makedirs(log_dir, exist_ok=True)
    log_file = os.path.join(log_dir, params.get("model_id", "") + ".log")
    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)
        if isinstance(handler, logging.FileHandler):
            handler.close()                 # an earlier run's log file
    handlers = [logging.FileHandler(log_file, mode="w")]
    if stream:
        handlers.append(logging.StreamHandler())
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s P%(process)d %(levelname)s %(message)s",
        handlers=handlers)
    import fuxictr_tpu_torch
    logging.info("fuxictr_tpu_torch version: %s",
                 fuxictr_tpu_torch.__version__)


def print_to_json(data, sort_keys=True):
    """Every value as its ``str``, as indented JSON (keys sorted)."""
    new_data = {k: str(v) for k, v in data.items()}
    if sort_keys:
        new_data = OrderedDict(sorted(new_data.items(), key=lambda x: x[0]))
    return json.dumps(new_data, indent=4)


def print_to_list(data):
    """``"key: value - key: value"`` with six decimals."""
    return " - ".join(f"{k}: {v:.6f}" for k, v in data.items())


class Monitor:
    """Weighted sum of validation metrics for early stopping, e.g.
    ``{"AUC": 1, "logloss": -1}``; a string names one metric of weight 1."""

    def __init__(self, kv):
        if isinstance(kv, str):
            kv = {kv: 1}
        self.kv_pairs = kv

    def get_value(self, logs):
        return sum(logs.get(k, 0) * w for k, w in self.kv_pairs.items())

    def get_metrics(self):
        return list(self.kv_pairs.keys())


def not_in_whitelist(element, whitelist=()):
    """True if ``element`` is excluded by a non-empty whitelist."""
    if not whitelist:
        return False
    if isinstance(whitelist, (list, tuple)):
        return element not in whitelist
    return element != whitelist

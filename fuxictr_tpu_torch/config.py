"""Config loading: the two-file YAML layout of ``fuxictr_tpu.config``.

``model_config.yaml`` holds a ``Base`` section merged under each expid
section (the expid wins); ``dataset_config.yaml`` is keyed by dataset_id.
``yaml`` is imported inside the readers, so importing this module needs no
PyYAML.
"""

import glob
import os


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


def not_in_whitelist(element, whitelist=()):
    """True if ``element`` is excluded by a non-empty whitelist."""
    if not whitelist:
        return False
    if isinstance(whitelist, (list, tuple)):
        return element not in whitelist
    return element != whitelist

"""Model registry: config ``model:`` strings to model classes. Zoo modules
register themselves when imported; :func:`get_model` imports the zoo on
first lookup."""

import importlib

MODEL_REGISTRY = {}


def register_model(cls=None, name=None):
    def wrap(c):
        MODEL_REGISTRY[name or c.__name__] = c
        return c
    if cls is None:
        return wrap
    return wrap(cls)


def get_model(name):
    if name not in MODEL_REGISTRY:
        importlib.import_module("fuxictr_tpu_torch.models.zoo")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model={name} is not registered. "
                       f"Available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]

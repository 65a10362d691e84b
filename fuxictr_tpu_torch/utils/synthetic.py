"""Synthetic Criteo-shaped schemas and batches, ported from
``fuxictr_tpu.utils.synthetic``: 13 numeric and 26 categorical fields by
default, made in memory from a seed. The same arguments give the JAX
package's schema and, draw for draw, its batches."""

from collections import OrderedDict

import numpy as np

from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.features import FeatureMap


def make_synthetic_feature_map(dataset_id="synthetic", num_categorical=26,
                               num_numeric=13, vocab_size=10000,
                               num_sequence=0, seq_len=20, embedding_dim=16):
    """A :class:`FeatureMap` resembling Criteo: numeric ``I{i}``, then
    categorical ``C{i}`` (padding id 0; ``vocab_size`` a number or a list
    cycled over the fields), then sequence ``S{i}`` sharing ``C1``'s rows.
    Sources cycle user / item / context. Label ``label``."""
    fm = FeatureMap(dataset_id, data_dir="")
    features = OrderedDict()
    sources = ("user", "item", "context")
    for i in range(num_numeric):
        features[f"I{i+1}"] = {"source": sources[i % 3], "type": "numeric"}
    vocabs = (list(vocab_size) if isinstance(vocab_size, (list, tuple))
              else [int(vocab_size)])
    for i in range(num_categorical):
        features[f"C{i+1}"] = {"source": sources[i % 3],
                               "type": "categorical", "padding_idx": 0,
                               "vocab_size": int(vocabs[i % len(vocabs)])}
    for i in range(num_sequence):
        features[f"S{i+1}"] = {"source": "user", "type": "sequence",
                               "padding_idx": 0, "vocab_size": int(vocabs[0]),
                               "max_len": seq_len}
        if num_categorical:
            features[f"S{i+1}"]["share_embedding"] = "C1"
    fm.features = features
    fm.labels = ["label"]
    fm.num_fields = fm.get_num_fields()
    fm.total_features = sum(s.get("vocab_size", 0) for s in features.values())
    fm.default_emb_dim = embedding_dim
    fm.set_column_index()
    return fm


def make_synthetic_batch(feature_map, batch_size=1024, seed=0):
    """One batch from ``np.random.default_rng(seed)``, drawn field by field
    in schema order: numeric standard normal (float32), sequence ids in
    ``[0, vocab)``, categorical ids in ``[1, vocab)`` (int32), then float32
    0/1 labels; every row real."""
    rng = np.random.default_rng(seed)
    batch = {}
    for name, spec in feature_map.features.items():
        t = spec["type"]
        if t == "numeric":
            batch[name] = rng.normal(size=(batch_size,)).astype(np.float32)
        elif t == "sequence":
            batch[name] = rng.integers(
                0, spec["vocab_size"], (batch_size, spec["max_len"]),
                dtype=np.int32)
        else:
            batch[name] = rng.integers(1, spec["vocab_size"], (batch_size,),
                                       dtype=np.int32)
    for label in feature_map.labels:
        batch[label] = rng.integers(0, 2, (batch_size,)).astype(np.float32)
    batch[SAMPLE_MASK_KEY] = np.ones((batch_size,), np.float32)
    return batch

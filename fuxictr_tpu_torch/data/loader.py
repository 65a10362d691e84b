"""Host-side batch iterators, ported from ``fuxictr_tpu.data.loader``.

Batches have a fixed shape: the last partial batch is padded with zero rows
up to ``batch_size``, and ``SAMPLE_MASK_KEY`` marks the real rows (1) and
the padding (0). Batches are numpy; the model moves them to its device.

``RankDataLoader`` is the loader facade: ``make_iterator()`` returns
``(train, valid)`` for ``stage="train"``, the test loader for ``"test"``
and all three for ``"both"``. The train loader shuffles when asked;
validation and test never do. With no ``data_loader`` it builds
:class:`InMemoryDataLoader`, as the JAX facade does; a class passed as
``data_loader`` (:class:`LongCTRDataLoader`) is built instead. The
streaming and device-cache loaders raise until the slices that port them.
Every other keyword goes to the loader.
"""

import logging

import numpy as np

from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.data.array_dataset import expand_path, load_columns


def _pad_batch(arrays, batch_size):
    """Every array padded with zero rows to ``batch_size``; returns the
    padded dict and the sample mask (float32, 0 on padded rows)."""
    n = len(next(iter(arrays.values())))
    mask = np.ones(batch_size, dtype=np.float32)
    if n == batch_size:
        return arrays, mask
    mask[n:] = 0.0
    padded = {}
    for k, v in arrays.items():
        pad_width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
        padded[k] = np.pad(v, pad_width)
    return padded, mask


class InMemoryDataLoader:
    """A whole split in host memory (every part file of ``data_path``,
    concatenated), sliced into batches. ``shuffle=True`` permutes the rows
    anew on each pass with ``np.random.default_rng(seed + epoch)``, the
    epoch counting the passes. ``len()`` is the number of batches. One host
    only: ``num_hosts > 1`` raises."""

    def __init__(self, feature_map, data_path, split="train", batch_size=32,
                 shuffle=False, seed=2019, host_id=0, num_hosts=1, **kwargs):
        if num_hosts > 1:
            raise NotImplementedError(
                "multi-host sharding of InMemoryDataLoader is not ported yet")
        self.feature_map = feature_map
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        cols = [load_columns(feature_map, p) for p in expand_path(data_path)]
        if len(cols) == 1:
            self.columns = cols[0]
        else:
            self.columns = {k: np.concatenate([c[k] for c in cols])
                            for k in cols[0]}
        self.num_samples = len(next(iter(self.columns.values())))
        self.num_blocks = 1
        self.num_batches = int(np.ceil(self.num_samples / batch_size))

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        bs = self.batch_size
        for start in range(0, self.num_samples, bs):
            idx = order[start:start + bs]
            batch, mask = _pad_batch({k: v[idx]
                                      for k, v in self.columns.items()}, bs)
            batch[SAMPLE_MASK_KEY] = mask
            yield batch


class RankDataLoader:

    def __init__(self, feature_map, stage="both", train_data=None,
                 valid_data=None, test_data=None, batch_size=32, shuffle=True,
                 streaming=False, data_loader=None, device_cache=False,
                 **kwargs):
        if device_cache or streaming:
            raise NotImplementedError(
                "the device-cache and streaming loaders are not ported yet")
        if data_loader is None:
            data_loader = InMemoryDataLoader
        elif not isinstance(data_loader, type):
            raise NotImplementedError(
                f"data_loader={data_loader!r}: pass a loader class "
                f"(InMemoryDataLoader, LongCTRDataLoader) or None")
        if stage not in ("both", "train", "test"):
            raise ValueError(f"stage={stage!r} is not train, test or both")
        logging.info("Loading datasets...")
        self.stage = stage
        self.train_gen = self.valid_gen = self.test_gen = None

        def make(path, split, shuffle):
            loader = data_loader(feature_map, path, split=split,
                                 batch_size=batch_size, shuffle=shuffle,
                                 **kwargs)
            logging.info("%s samples: total/%d", split.capitalize(),
                         loader.num_samples)
            return loader

        if stage in ("both", "train"):
            self.train_gen = make(train_data, "train", shuffle)
            if valid_data:
                self.valid_gen = make(valid_data, "valid", False)
        if stage in ("both", "test") and test_data:
            self.test_gen = make(test_data, "test", False)

    def make_iterator(self):
        if self.stage == "train":
            return self.train_gen, self.valid_gen
        if self.stage == "test":
            return self.test_gen
        return self.train_gen, self.valid_gen, self.test_gen

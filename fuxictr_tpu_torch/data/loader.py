"""``RankDataLoader``: the loader facade of ``fuxictr_tpu.data.loader``.

``make_iterator()`` returns ``(train, valid)`` for ``stage="train"``, the
test loader for ``"test"`` and all three for ``"both"``. The train loader
shuffles when asked; validation and test never do. The port has one loader
so far: ``data_loader`` must be :class:`LongCTRDataLoader`; the in-memory,
streaming and device-cache loaders raise until the slices that port them.
Every other keyword goes to the loader.
"""

import logging

from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader


class RankDataLoader:

    def __init__(self, feature_map, stage="both", train_data=None,
                 valid_data=None, test_data=None, batch_size=32, shuffle=True,
                 streaming=False, data_loader=None, device_cache=False,
                 **kwargs):
        if data_loader is not LongCTRDataLoader:
            raise NotImplementedError(
                f"data_loader={data_loader!r}: the port has only "
                f"LongCTRDataLoader so far")
        if device_cache or streaming:
            raise NotImplementedError(
                "the device-cache and streaming LongCTR loaders are not "
                "ported yet")
        if stage not in ("both", "train", "test"):
            raise ValueError(f"stage={stage!r} is not train, test or both")
        self.stage = stage
        self.train_gen = self.valid_gen = self.test_gen = None
        make = lambda path, shuffle: LongCTRDataLoader(  # noqa: E731
            feature_map, path, batch_size=batch_size, shuffle=shuffle,
            **kwargs)
        if stage in ("both", "train"):
            self.train_gen = make(train_data, shuffle)
            logging.info("Train samples: total/%d",
                         self.train_gen.num_samples)
            if valid_data:
                self.valid_gen = make(valid_data, False)
                logging.info("Validation samples: total/%d",
                             self.valid_gen.num_samples)
        if stage in ("both", "test") and test_data:
            self.test_gen = make(test_data, False)
            logging.info("Test samples: total/%d", self.test_gen.num_samples)

    def make_iterator(self):
        if self.stage == "train":
            return self.train_gen, self.valid_gen
        if self.stage == "test":
            return self.test_gen
        return self.train_gen, self.valid_gen, self.test_gen

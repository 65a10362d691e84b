"""LongCTR side-table loader, ported from ``fuxictr_tpu.data.longctr_loader``.

The interaction table holds ``(user_index, item_index, seq_len, ...)``;
each user's full item sequence lives in the user side table and each item's
features in the item side table, joined when a batch is collated. Batches
have a fixed shape: the history keeps its last ``max_len`` items and is
pre-padded, the last partial batch is padded with zero rows, and the joined
item features come as a nested ``"__items__"`` dict of ``[B*(max_len+1)]``
arrays (history, then target). Batches are numpy; the model moves them to
its device.

Each table may be a parquet path (read with pandas, imported only then) or
in-memory numpy: a dict of columns for the interaction and item tables, a
sequence of 1-D id arrays for the user table.

``shuffle=True`` permutes the rows anew each epoch with the loader's own
``np.random.RandomState(seed)``: the permutations the JAX loader draws from
numpy's global generator after ``seed_everything(seed)``.
"""

import numpy as np

from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.ops.embedding import INVERSE_KEY

ITEMS_KEY = "__items__"
SEQ_MASK_KEY = "__seq_mask__"


def pad_sequences(seqs, lens, max_len):
    """Variable-length sequences to ``[n, max_len]`` int64: the first
    ``lens[i]`` ids of ``seqs[i]`` are valid; keep the last ``max_len`` of
    them and pad in front with 0."""
    out = np.zeros((len(seqs), max_len), np.int64)
    for i, (s, n) in enumerate(zip(seqs, lens)):
        s = np.asarray(s, np.int64)[:int(n)][-max_len:]
        out[i, max_len - len(s):] = s
    return out


def unique_inverse(ids):
    """``(uniq, inv)`` with ``uniq[inv] == ids``."""
    uniq, inv = np.unique(np.asarray(ids, np.int64), return_inverse=True)
    return uniq, inv.astype(np.int32)


def _read_table(src):
    if isinstance(src, dict):
        return {k: np.asarray(v) for k, v in src.items()}
    import pandas as pd
    path = str(src)
    if not path.endswith(".parquet"):
        path += ".parquet"
    df = pd.read_parquet(path)
    return {c: df[c].to_numpy() for c in df.columns}


def _read_user_seqs(src):
    if isinstance(src, (str, bytes)) or hasattr(src, "__fspath__"):
        return _read_table(src)["full_item_seq"]
    return src


class LongCTRDataLoader:
    """``dedup_items=True`` (default) emits each batch's unique item rows,
    padded with id 0 to a power-of-two bucket of at least
    ``dedup_min_bucket``, plus the ``__item_inverse__`` index that expands
    them back to the flat layout."""

    def __init__(self, feature_map, data_path, batch_size=32, shuffle=False,
                 user_info=None, item_info=None, max_len=50,
                 dedup_items=True, dedup_min_bucket=4096, seed=2019,
                 **kwargs):
        self.feature_map = feature_map
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.batch_size = batch_size
        self.max_len = max_len
        self.dedup_items = dedup_items
        self.dedup_min_bucket = dedup_min_bucket
        all_cols = set(list(feature_map.features) + feature_map.labels
                       + ["user_index", "item_index", "seq_len"])
        table = _read_table(data_path)
        self.columns = {c: a for c, a in table.items() if c in all_cols}
        self.num_samples = len(table["user_index"])
        self.num_batches = int(np.ceil(self.num_samples / batch_size))
        self.user_seqs = _read_user_seqs(user_info)
        items = _read_table(item_info)
        index = np.asarray(items.pop("item_index"))
        self.item_cols = {
            c: (np.stack(list(a)) if a.dtype == object else a)
            for c, a in items.items() if c in all_cols}
        if np.array_equal(index, np.arange(len(index))):
            self._lut = None
        else:
            self._lut = np.zeros(int(index.max()) + 1, np.int64)
            self._lut[index] = np.arange(len(index))

    def __len__(self):
        return self.num_batches

    def _gather_items(self, flat_ids):
        rows = self._lut[flat_ids] if self._lut is not None else flat_ids
        return {col: arr[rows] for col, arr in self.item_cols.items()}

    def __iter__(self):
        L = self.max_len
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, self.num_samples, self.batch_size):
            idx = order[start:start + self.batch_size]
            n = len(idx)
            batch = {col: arr[idx] for col, arr in self.columns.items()}
            seqs = pad_sequences(
                [self.user_seqs[u] for u in batch["user_index"]],
                batch["seq_len"].astype(np.int64), L)
            batch[SEQ_MASK_KEY] = (seqs > 0).astype(np.float32)
            flat = np.hstack([seqs, batch["item_index"].reshape(-1, 1)])
            sample_mask = np.ones(n, np.float32)
            if n < self.batch_size:
                pad = self.batch_size - n
                batch = {k: np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in batch.items()}
                flat = np.concatenate(
                    [flat, np.zeros((pad, L + 1), flat.dtype)])
                sample_mask = np.concatenate(
                    [sample_mask, np.zeros(pad, np.float32)])
            flat = flat.reshape(-1)
            if self.dedup_items:
                uniq, inv = unique_inverse(flat)
                cap = self.dedup_min_bucket
                while cap < uniq.shape[0]:
                    cap *= 2
                ids = np.zeros(min(cap, flat.shape[0]), flat.dtype)
                ids[:uniq.shape[0]] = uniq
                batch[ITEMS_KEY] = self._gather_items(ids)
                batch[ITEMS_KEY][INVERSE_KEY] = inv
            else:
                batch[ITEMS_KEY] = self._gather_items(flat)
            batch[SAMPLE_MASK_KEY] = sample_mask
            yield batch

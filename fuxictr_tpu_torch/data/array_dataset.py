"""Columnar dataset loading, ported from ``fuxictr_tpu.data.array_dataset``.

A split is a typed column store: one contiguous ndarray per feature, int32
ids and float32 values and labels, so that a batch is a slice of each
column. Parquet (read with pyarrow, imported only then) and npz files are
read; ``.tfrecord`` is not ported yet and raises.
"""

import glob
import os

import numpy as np


def _feature_dtype(spec):
    t = spec["type"]
    if t in ("categorical", "sequence"):
        return np.int32
    if t in ("numeric", "embedding"):
        return np.float32
    return None  # meta: kept as read


def _parquet_getter(data_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    table = pq.read_table(data_path)

    def get(col):
        arr = table[col].combine_chunks()
        if pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type):
            # fixed-length list columns (sequences padded at build time):
            # flattened from the arrow buffers, ragged ones zero-padded
            offsets = np.asarray(arr.offsets)
            lengths = np.diff(offsets)
            flat = arr.flatten().to_numpy(zero_copy_only=False)
            if len(lengths) and np.all(lengths == lengths[0]):
                return flat.reshape(len(arr), int(lengths[0]))
            max_len = int(lengths.max()) if len(lengths) else 0
            out = np.zeros((len(arr), max_len), flat.dtype)
            for i, (s, e) in enumerate(zip(offsets[:-1], offsets[1:])):
                out[i, :e - s] = flat[s:e]
            return out
        return arr.to_numpy(zero_copy_only=False)
    return get


def load_columns(feature_map, data_path):
    """One data file (parquet, or npz) as ``{name: ndarray}``: ``[N]``
    per scalar field, ``[N, max_len]`` per sequence field, ``[N,
    pretrain_dim]`` per ``embedding`` field, labels float32. A path with no
    extension is read as ``<path>.parquet``."""
    if data_path.endswith(".tfrecord"):
        raise NotImplementedError("tfrecord data is not ported yet")
    if data_path.endswith(".npz"):
        raw = np.load(data_path, allow_pickle=True)
        get = raw.__getitem__
    else:
        if not os.path.splitext(data_path)[1]:
            data_path += ".parquet"
        get = _parquet_getter(data_path)
    columns = {}
    for name, spec in feature_map.features.items():
        arr = np.asarray(get(name))
        dtype = _feature_dtype(spec)
        if dtype is not None:
            arr = np.ascontiguousarray(arr, dtype=dtype)
        columns[name] = arr
    for label in feature_map.labels:
        columns[label] = np.ascontiguousarray(get(label), dtype=np.float32)
    return columns


def expand_path(data_path):
    """The part files of ``data_path``: a file, a glob, or a directory of
    ``*.parquet`` / ``*.npz`` / ``*.tfrecord`` parts, sorted."""
    if os.path.isdir(data_path):
        for ext in ("*.parquet", "*.npz", "*.tfrecord"):
            parts = sorted(glob.glob(os.path.join(data_path, ext)))
            if parts:
                return parts
        return []
    if any(ch in data_path for ch in "*?["):
        return sorted(glob.glob(data_path))
    if not os.path.exists(data_path) \
            and os.path.exists(data_path + ".parquet"):
        return [data_path + ".parquet"]
    return [data_path]

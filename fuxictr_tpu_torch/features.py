"""Feature schema: reads the ``feature_map.json`` that ``fuxictr_tpu``
writes (same schema, same runtime overrides). Writing it stays with the
JAX package's preprocessing for now."""

import io
import json
from collections import OrderedDict


class FeatureMap:
    """Feature specs, labels and the flat column index of a dataset."""

    def __init__(self, dataset_id, data_dir=""):
        self.data_dir = data_dir
        self.dataset_id = dataset_id
        self.num_fields = 0
        self.total_features = 0
        self.input_length = 0
        self.features = OrderedDict()
        self.labels = []
        self.column_index = {}
        self.group_id = None
        self.default_emb_dim = None

    def load(self, json_file, params=None):
        """Load the schema, applying the runtime overrides ``group_id``,
        ``embedding_dim``, ``use_features`` and ``feature_specs``."""
        params = params or {}
        with io.open(json_file, "r", encoding="utf-8") as fd:
            spec = json.load(fd)
        if spec["dataset_id"] != self.dataset_id:
            raise RuntimeError(
                f"dataset_id={self.dataset_id} does not match feature_map "
                f"({spec['dataset_id']})!")
        self.labels = spec.get("labels", [])
        self.total_features = spec.get("total_features", 0)
        self.input_length = spec.get("input_length", 0)
        self.group_id = params.get("group_id", None)
        self.default_emb_dim = params.get("embedding_dim", None)
        self.features = OrderedDict(
            (k, v) for entry in spec["features"] for k, v in entry.items())
        self.num_fields = self.get_num_fields()
        if params.get("use_features"):
            self.features = OrderedDict(
                (name, self.features[name]) for name in params["use_features"])
        if params.get("feature_specs"):
            self.update_feature_specs(params["feature_specs"])
        self.set_column_index()

    def update_feature_specs(self, feature_specs):
        """Merge spec overrides (a list of dicts, each with ``name``)."""
        for col in feature_specs:
            names = col["name"]
            if not isinstance(names, list):
                names = [names]
            for name in names:
                for k, v in col.items():
                    if k != "name":
                        self.features[name][k] = v

    def get_num_fields(self, feature_source=()):
        """Number of non-meta fields, optionally filtered by source."""
        if not isinstance(feature_source, (list, tuple)):
            feature_source = [feature_source]
        return sum(1 for fs in self.features.values()
                   if fs["type"] != "meta"
                   and (not feature_source
                        or fs.get("source") in feature_source))

    def set_column_index(self):
        """Flat column indices: sequence/embedding fields span a range."""
        idx = 0
        for feature, fs in self.features.items():
            if fs["type"] == "sequence":
                self.column_index[feature] = list(range(idx,
                                                        idx + fs["max_len"]))
                idx += fs["max_len"]
            elif fs["type"] == "embedding":
                dim = fs["pretrain_dim"]
                self.column_index[feature] = list(range(idx, idx + dim))
                idx += dim
            else:
                self.column_index[feature] = idx
                idx += 1
        self.input_length = idx
        for label in self.labels:
            self.column_index[label] = idx
            idx += 1

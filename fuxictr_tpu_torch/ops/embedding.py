"""Fused feature embeddings, ported from ``fuxictr_tpu.ops.embedding``.

All categorical vocabularies that share an embedding dim and a size bucket
are packed into ONE ``[rows, dim]`` table with per-field row offsets, under
the JAX package's table names (``table_d{dim}`` / ``table_d{dim}b{k}``), so
its parameters copy over as they are. ``padding_idx`` rows read as zeros.

This slice ports the forward of categorical fields, which is what SIM
serves: the stacked ``[B, F]`` gather per table, the loader-deduped expand
through ``__item_inverse__``, and the per-field lookup. The gathers are
plain torch indexing; numeric, sequence, ``embedding``-type, pretrained and
encoded fields raise.
"""

from collections import OrderedDict

import torch
from torch import nn


# batch-dict key carrying the dedup inverse index (data/longctr_loader.py)
INVERSE_KEY = "__item_inverse__"

# vocab-size edges of the table buckets (tiny <= 8k, mid <= 128k, big)
DEFAULT_TABLE_SIZE_BUCKETS = (8192, 131072)
# fuxictr_tpu's default embedding_initializer, "normal(std=1e-4)"
TABLE_INIT_STD = 1e-4


class EmbeddingLayout:
    """Host-side plan of the fused-table packing, identical to the JAX
    package's for the same feature map: ``fields`` (name -> plan with
    ``table``, ``offset``, ``padding_idx``) and ``tables`` (name ->
    ``{"rows", "dim"}``). ``size_buckets`` resolves explicit arg >
    ``feature_map.table_size_buckets`` > the default; ``()`` gives one
    table per dim. Fields with ``share_embedding`` alias their owner's
    rows."""

    def __init__(self, feature_map, embedding_dim, size_buckets=None):
        self.feature_map = feature_map
        if size_buckets is None:
            size_buckets = getattr(feature_map, "table_size_buckets", None)
        if size_buckets is None:
            size_buckets = DEFAULT_TABLE_SIZE_BUCKETS
        self.size_buckets = tuple(sorted(size_buckets))
        self.fields = OrderedDict()
        self.tables = OrderedDict()
        vocab_offset = {}             # (dim, bucket) -> running row count

        def bucket_of(vocab_size):
            for i, edge in enumerate(self.size_buckets):
                if vocab_size <= edge:
                    return i
            return len(self.size_buckets)

        for name, spec in feature_map.features.items():
            ftype = spec["type"]
            if ftype == "meta":
                continue
            dim = spec.get("embedding_dim", embedding_dim)
            plan = {"type": ftype, "dim": dim, "spec": spec}
            if ftype in ("categorical", "sequence"):
                if "pretrained_emb" in spec:
                    plan["pretrained"] = True
                else:
                    owner = spec.get("share_embedding")
                    if owner and owner in self.fields \
                            and "offset" in self.fields[owner]:
                        plan["offset"] = self.fields[owner]["offset"]
                        plan["bucket"] = self.fields[owner]["bucket"]
                    else:
                        key = (dim, bucket_of(spec["vocab_size"]))
                        off = vocab_offset.setdefault(key, 0)
                        plan["offset"] = off
                        plan["bucket"] = key[1]
                        vocab_offset[key] = off + spec["vocab_size"]
                plan["padding_idx"] = spec.get("padding_idx", -1)
                if plan["padding_idx"] is None:
                    plan["padding_idx"] = -1
            self.fields[name] = plan

        # a dim with a single bucket keeps the name table_d{dim}
        buckets_by_dim = {}
        for (dim, b) in vocab_offset:
            buckets_by_dim.setdefault(dim, []).append(b)
        table_name = {}
        for dim, bs in buckets_by_dim.items():
            bs = sorted(bs)
            for k, b in enumerate(bs):
                name = (f"table_d{dim}" if len(bs) == 1
                        else f"table_d{dim}b{k}")
                table_name[(dim, b)] = name
                self.tables[name] = {"rows": vocab_offset[(dim, b)],
                                     "dim": dim}
        for plan in self.fields.values():
            if "bucket" in plan:
                plan["table"] = table_name[(plan["dim"], plan["bucket"])]


class FeatureEmbedding(nn.Module):
    """Batch dict -> per-field embeddings -> ``[B, F, D]`` or ``[B, F*D]``.

    Each fused table is a parameter named as in the JAX package, so
    ``embedding.table_d32b1`` in the state dict is ``params["embedding"]
    ["table_d32b1"]`` there. Tables are drawn from ``generator`` with the
    JAX package's default init, normal with std 1e-4."""

    def __init__(self, feature_map, embedding_dim, size_buckets=None,
                 generator=None):
        super().__init__()
        self.layout = EmbeddingLayout(feature_map, embedding_dim,
                                      size_buckets=size_buckets)
        for name, plan in self.layout.fields.items():
            spec = plan["spec"]
            if (plan["type"] != "categorical" or plan.get("pretrained")
                    or spec.get("feature_encoder")):
                raise NotImplementedError(
                    f"field {name}: only plain categorical fields are "
                    f"ported so far")
        for tname, info in self.layout.tables.items():
            table = torch.empty(info["rows"], info["dim"])
            nn.init.normal_(table, 0.0, TABLE_INIT_STD, generator=generator)
            self.register_parameter(tname, nn.Parameter(table))

    def _table(self, tname):
        return getattr(self, tname)

    def _present(self, batch):
        """Layout-ordered fields present in ``batch``."""
        return [(name, plan) for name, plan in self.layout.fields.items()
                if name in batch]

    def _groups(self, batch):
        """Tables with two or more fields in ``batch``: their fields, global
        row ids and padding masks, for one stacked op per table."""
        by_table = {}
        for name, plan in self._present(batch):
            by_table.setdefault(plan["table"], []).append((name, plan))
        groups = {}
        for tname, fields in by_table.items():
            if len(fields) < 2:
                continue
            ids, masks = [], []
            for name, plan in fields:
                local = batch[name].long()
                ids.append(local + plan["offset"])
                pad = plan["padding_idx"]
                masks.append(local != pad if pad >= 0
                             else torch.ones_like(local, dtype=torch.bool))
            groups[tname] = (fields, ids, masks)
        return groups

    def _grouped_gather(self, batch):
        """One ``[B, F]`` gather per fused table, times the padding mask."""
        out = {}
        for tname, (fields, ids, masks) in self._groups(batch).items():
            table = self._table(tname)
            emb = table[torch.stack(ids, dim=1)]              # [B, F, D]
            emb = emb * torch.stack(masks, dim=1)[..., None].to(emb.dtype)
            for i, (name, _) in enumerate(fields):
                out[name] = emb[:, i, :]
        return out

    def _grouped_expand(self, batch, inv):
        """Deduped dicts: gather each field's unique rows, mask them, and
        expand all of a table's fields through ``inv`` at once."""
        out = {}
        for tname, (fields, ids, masks) in self._groups(batch).items():
            table = self._table(tname)
            uniq = torch.cat([table[i] * m[:, None].to(table.dtype)
                              for i, m in zip(ids, masks)], dim=-1)
            emb = uniq[inv]                                    # [N, F*D]
            dim = fields[0][1]["dim"]
            for i, (name, _) in enumerate(fields):
                out[name] = emb[:, i * dim:(i + 1) * dim]
        return out

    def _lookup_fused(self, batch, plan, name, inv=None):
        ids = batch[name].long()
        rows = self._table(plan["table"])[ids + plan["offset"]]
        if inv is not None:
            rows, ids = rows[inv], ids[inv]
        pad = plan["padding_idx"]
        if pad >= 0:
            rows = rows * (ids != pad)[..., None].to(rows.dtype)
        return rows

    def embedding_dict(self, batch):
        """OrderedDict of per-field ``[B, D]`` embeddings, in layout order.
        A batch that carries ``INVERSE_KEY`` holds unique rows; every field
        is expanded back to the flat layout through it."""
        inv = batch.get(INVERSE_KEY)
        if inv is not None:
            inv = inv.long()
            grouped = self._grouped_expand(batch, inv)
        else:
            grouped = self._grouped_gather(batch)
        out = OrderedDict()
        for name, plan in self._present(batch):
            out[name] = (grouped[name] if name in grouped
                         else self._lookup_fused(batch, plan, name, inv))
        return out

    def dict2tensor(self, emb_dict, flatten_emb=False):
        """Stack to ``[B, F, D]`` (equal dims), or concatenate to
        ``[B, sum D]``, in layout-field order."""
        arrs = [emb_dict[name] for name in self.layout.fields
                if name in emb_dict]
        if flatten_emb:
            return torch.cat([a.reshape(a.shape[0], -1) for a in arrs],
                             dim=-1)
        return torch.stack(arrs, dim=1)

    def forward(self, batch, flatten_emb=False):
        return self.dict2tensor(self.embedding_dict(batch),
                                flatten_emb=flatten_emb)

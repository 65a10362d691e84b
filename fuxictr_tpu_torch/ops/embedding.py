"""Fused feature embeddings, ported from ``fuxictr_tpu.ops.embedding``.

All categorical vocabularies that share an embedding dim and a size bucket
are packed into ONE ``[rows, dim]`` table with per-field row offsets, under
the JAX package's table names (``table_d{dim}`` / ``table_d{dim}b{k}``), so
its parameters copy over as they are. ``padding_idx`` rows read as zeros.

Ported so far: categorical fields (the stacked ``[B, F]`` gather per
table, the loader-deduped expand through ``__item_inverse__``, and the
per-field lookup) and numeric fields (``x * w``, one ``[fields, dim]``
weight per dim, ``numeric_d{dim}``), with the layout options that
``LogisticRegression`` sets (``force_dim``, ``use_pretrain``,
``use_sharing``). Forwards are plain torch indexing. The plain gathers
train through autograd, as the JAX package's ``table_gather`` is a plain
``jnp.take`` under autodiff. The deduped expand
(:func:`table_gather_expand`, :func:`table_gather_expand_multi`) is an
autograd Function whose backward is the JAX package's custom VJP: on CUDA a
hand-written deterministic kernel (``csrc/table_gather_expand.cu``), on the
CPU its plain version. Sequence, ``embedding``-type, pretrained and encoded
fields raise; ``pool_sequences`` is not ported.
"""

import ctypes
import functools
import math
from collections import OrderedDict

import torch
from torch import nn

from fuxictr_tpu_torch.ops import cuda_build


# batch-dict key carrying the dedup inverse index (data/longctr_loader.py)
INVERSE_KEY = "__item_inverse__"

# vocab-size edges of the table buckets (tiny <= 8k, mid <= 128k, big)
DEFAULT_TABLE_SIZE_BUCKETS = (8192, 131072)
# fuxictr_tpu's default embedding_initializer, "normal(std=1e-4)"
TABLE_INIT_STD = 1e-4


# sorted positions per warp in the kernel's first pass
_TILE = 256


def table_gather_expand_bwd_reference(g, inv, ids_stack, mask_stack,
                                      num_rows):
    """Plain gradient of the deduped expand, as the JAX package's
    ``_tge_bwd`` / ``_tgem_bwd`` compute it, in g's type: segment-sum
    ``g`` [N, k*D] into a [U, k*D] temp through ``inv``, then add each
    field's D columns, times its mask, into a [num_rows, D] table through
    ``ids_stack[i]``, one field after another."""
    k, U = ids_stack.shape
    D = g.shape[1] // k
    seg = torch.zeros(U, g.shape[1], dtype=g.dtype,
                      device=g.device).index_add_(0, inv, g)
    grad = torch.zeros(num_rows, D, dtype=g.dtype, device=g.device)
    for i in range(k):
        part = seg[:, i * D:(i + 1) * D]
        if mask_stack is not None:
            part = part * mask_stack[i][:, None].to(part.dtype)
        grad.index_add_(0, ids_stack[i], part)
    return grad


_EXPAND_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _expand_library():
    lib = ctypes.CDLL(cuda_build.build("table_gather_expand"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for tag in _EXPAND_TAGS.values():
        fn = getattr(lib, f"table_gather_expand_bwd_{tag}")
        fn.argtypes = [P] * 10 + [I] * 4 + [ctypes.c_longlong, I, P]
        fn.restype = ctypes.c_int
    lib.table_gather_expand_error_string.argtypes = [ctypes.c_int]
    lib.table_gather_expand_error_string.restype = ctypes.c_char_p
    return lib


def table_gather_expand_bwd_cuda(g, inv, ids_stack, mask_stack, num_rows):
    """Launch the backward kernel on the current stream: ``g`` [N, k*D]
    float32 or bfloat16, ``inv`` [N] int64, ``ids_stack`` [k, U] int64 and
    ``mask_stack`` [k, U] bool (or None: all ones), contiguous, on one CUDA
    device. Returns the [num_rows, D] table gradient in g's type, summed
    in float32 and rounded once, the same bits on every run (no atomics).
    The ids and inv are the forward's, which its indexing has bounded.
    Its helper sorts run on the same stream and count in its time."""
    if g.dtype not in _EXPAND_TAGS:
        raise TypeError(f"table_gather_expand_bwd_cuda takes a float32 or "
                        f"bfloat16 gradient, not {g.dtype}")
    if inv.dtype != torch.int64 or ids_stack.dtype != torch.int64:
        raise TypeError("table_gather_expand_bwd_cuda takes int64 inv and ids")
    if mask_stack is not None and mask_stack.dtype != torch.bool:
        raise TypeError("table_gather_expand_bwd_cuda takes a bool mask")
    tensors = [t for t in (g, inv, ids_stack, mask_stack) if t is not None]
    if not all(t.is_cuda and t.device == g.device for t in tensors):
        raise ValueError("table_gather_expand_bwd_cuda: all inputs must be on "
                         "one CUDA device")
    if ids_stack.dim() != 2 or g.dim() != 2 or inv.shape != g.shape[:1]:
        raise ValueError(f"shapes g {tuple(g.shape)}, inv {tuple(inv.shape)}, "
                         f"ids {tuple(ids_stack.shape)} do not agree")
    k, U = ids_stack.shape
    N, C = g.shape
    if k == 0 or C % k or (mask_stack is not None
                           and mask_stack.shape != ids_stack.shape):
        raise ValueError(f"g has {C} columns for {k} fields, or the mask's "
                         f"shape is not ids' {tuple(ids_stack.shape)}")
    if N * C >= 2 ** 31 or k * U >= 2 ** 31:
        raise ValueError("table_gather_expand_bwd_cuda: too many rows")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table_gather_expand_bwd_cuda takes contiguous "
                         "tensors")
    D = C // k
    dtable = torch.empty(num_rows, D, dtype=g.dtype, device=g.device)
    if N == 0 or U == 0:
        return dtable.zero_()
    inv_sorted, perm = torch.sort(inv, stable=True)
    keys_sorted, eperm = torch.sort(ids_stack.reshape(-1), stable=True)
    bounds = torch.empty(2 * U, dtype=torch.int32, device=g.device)
    seg = torch.empty(U, C, dtype=torch.float32, device=g.device)
    head = torch.empty(-(-N // _TILE), C, dtype=torch.float32,
                       device=g.device)
    lib = _expand_library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    entry = getattr(lib, f"table_gather_expand_bwd_{_EXPAND_TAGS[g.dtype]}")
    with torch.cuda.device(g.device):
        code = entry(
            g.data_ptr(), inv_sorted.data_ptr(), perm.data_ptr(),
            keys_sorted.data_ptr(), eperm.data_ptr(),
            None if mask_stack is None else mask_stack.data_ptr(),
            bounds.data_ptr(), seg.data_ptr(), head.data_ptr(),
            dtable.data_ptr(), N, U, k, D, num_rows, _TILE, stream)
    if code != 0:
        raise RuntimeError(
            "table_gather_expand backward kernel launch failed: "
            + lib.table_gather_expand_error_string(code).decode())
    table_gather_expand_bwd_cuda.launches += 1
    return dtable


table_gather_expand_bwd_cuda.launches = 0


class TableGatherExpandFunction(torch.autograd.Function):
    """``concat_i(table[ids_stack[i]] * mask_stack[i])[inv]`` (no mask:
    all ones), [N, k*D]. The forward is torch indexing; the backward is
    :func:`table_gather_expand_bwd_cuda` on CUDA tensors and
    :func:`table_gather_expand_bwd_reference` on CPU tensors. Only the
    table takes a gradient."""

    @staticmethod
    def forward(ctx, table, ids_stack, inv, mask_stack):
        parts = [table[ids] if mask_stack is None
                 else table[ids] * mask_stack[i][:, None].to(table.dtype)
                 for i, ids in enumerate(ids_stack)]
        ctx.num_rows = table.shape[0]
        ctx.save_for_backward(ids_stack, inv, mask_stack)
        return torch.cat(parts, dim=-1)[inv]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        ids_stack, inv, mask_stack = ctx.saved_tensors
        bwd = (table_gather_expand_bwd_cuda if g.is_cuda
               else table_gather_expand_bwd_reference)
        return (bwd(g.contiguous(), inv, ids_stack, mask_stack,
                    ctx.num_rows), None, None, None)


def table_gather_expand(table, ids, inv):
    """Deduped lookup ``table[ids][inv]`` with the segment-sum backward
    (``fuxictr_tpu.ops.embedding.table_gather_expand``)."""
    return TableGatherExpandFunction.apply(table, ids[None], inv, None)


def table_gather_expand_multi(table, ids_stack, inv, mask_stack):
    """k fields of one fused table, deduped, expanded at once: [N, k*D]
    (``fuxictr_tpu.ops.embedding.table_gather_expand_multi``)."""
    return TableGatherExpandFunction.apply(table, ids_stack, inv, mask_stack)


class EmbeddingLayout:
    """Host-side plan of the fused-table packing, identical to the JAX
    package's for the same feature map: ``fields`` (name -> plan with
    ``table``, ``offset``, ``padding_idx``; a numeric field's plan has its
    ``numeric_index``), ``tables`` (name -> ``{"rows", "dim"}``) and
    ``numeric`` (dim -> numeric field names). ``size_buckets`` resolves
    explicit arg > ``feature_map.table_size_buckets`` > the default; ``()``
    gives one table per dim. ``force_dim`` gives every field that dim.
    Fields with ``share_embedding`` alias their owner's rows unless
    ``use_sharing`` is false; with ``use_pretrain`` false a field's
    ``pretrained_emb`` is ignored and it takes fused rows."""

    def __init__(self, feature_map, embedding_dim, size_buckets=None,
                 use_pretrain=True, use_sharing=True, force_dim=None):
        self.feature_map = feature_map
        if size_buckets is None:
            size_buckets = getattr(feature_map, "table_size_buckets", None)
        if size_buckets is None:
            size_buckets = DEFAULT_TABLE_SIZE_BUCKETS
        self.size_buckets = tuple(sorted(size_buckets))
        self.fields = OrderedDict()
        self.tables = OrderedDict()
        self.numeric = {}             # dim -> [field names]
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
            dim = force_dim or spec.get("embedding_dim", embedding_dim)
            plan = {"type": ftype, "dim": dim, "spec": spec}
            if ftype == "numeric":
                plan["numeric_index"] = len(self.numeric.setdefault(dim, []))
                self.numeric[dim].append(name)
            elif ftype in ("categorical", "sequence"):
                if use_pretrain and "pretrained_emb" in spec:
                    plan["pretrained"] = True
                else:
                    owner = spec.get("share_embedding") if use_sharing \
                        else None
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
    JAX package's default init, normal with std 1e-4. Numeric fields of one
    dim share the parameter ``numeric_d{dim}`` ``[fields, dim]``, row
    ``numeric_index`` per field, drawn normal with std ``sqrt(2 / (1 +
    dim))`` (each field a ``Linear(1, dim)``); a field's embedding is its
    value times its row."""

    def __init__(self, feature_map, embedding_dim, size_buckets=None,
                 generator=None, use_pretrain=True, use_sharing=True,
                 force_dim=None):
        super().__init__()
        self.layout = EmbeddingLayout(
            feature_map, embedding_dim, size_buckets=size_buckets,
            use_pretrain=use_pretrain, use_sharing=use_sharing,
            force_dim=force_dim)
        for name, plan in self.layout.fields.items():
            spec = plan["spec"]
            if (plan["type"] not in ("categorical", "numeric")
                    or plan.get("pretrained") or spec.get("feature_encoder")):
                raise NotImplementedError(
                    f"field {name}: only plain categorical and numeric "
                    f"fields are ported so far")
        for tname, info in self.layout.tables.items():
            table = torch.empty(info["rows"], info["dim"])
            nn.init.normal_(table, 0.0, TABLE_INIT_STD, generator=generator)
            self.register_parameter(tname, nn.Parameter(table))
        for dim, names in self.layout.numeric.items():
            weight = torch.empty(len(names), dim)
            nn.init.normal_(weight, 0.0, math.sqrt(2.0 / (1 + dim)),
                            generator=generator)
            self.register_parameter(f"numeric_d{dim}", nn.Parameter(weight))

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
            if plan["type"] == "categorical":
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
        """Deduped dicts: expand all of a table's fields through ``inv`` in
        one :func:`table_gather_expand_multi`."""
        out = {}
        for tname, (fields, ids, masks) in self._groups(batch).items():
            emb = table_gather_expand_multi(
                self._table(tname), torch.stack(ids), inv,
                torch.stack(masks))                        # [N, F*D]
            dim = fields[0][1]["dim"]
            for i, (name, _) in enumerate(fields):
                out[name] = emb[:, i * dim:(i + 1) * dim]
        return out

    def _lookup_fused(self, batch, plan, name, inv=None):
        ids = batch[name].long()
        table = self._table(plan["table"])
        if inv is None:
            rows = table[ids + plan["offset"]]
        else:
            rows = table_gather_expand(table, ids + plan["offset"], inv)
            ids = ids[inv]
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
            if plan["type"] == "numeric":
                w = getattr(self, f"numeric_d{plan['dim']}")
                emb = (batch[name].float().reshape(-1, 1)
                       * w[plan["numeric_index"]])
                out[name] = emb if inv is None else emb[inv]
            elif name in grouped:
                out[name] = grouped[name]
            else:
                out[name] = self._lookup_fused(batch, plan, name, inv)
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fuxictr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port from ``fuxictr_tpu_torch/ops/csrc``
   (one nvcc per source, started together) and print what ``ptxas`` says
   of each kernel instance;
3. hold K1's forward against its plain PyTorch version on the card, in
   float32 and in bfloat16, at the shapes SIM gives it and a few more, and
   time kernel, plain version and the one PyTorch call that computes the
   same function (a yardstick only);
4. serve SIM at the repo's full width (embedding 32, attention 64, MLP
   [512, 256], short window 100, top-k 100, max_len 1000, batch 1024) on
   seeded synthetic side tables through ``LongCTRDataLoader``,
   ``RankModel.predict`` and ``RankModel.evaluate``, once in float32 and
   once with ``compute_dtype="bfloat16"`` as ``scripts/run_longctr_scale.py``
   runs it; check that each path launched every kernel exactly as often as
   its forwards call it, and that its outputs agree with a run whose
   attention takes the plain version;
5. hold the backward kernels against their plain versions in both types:
   K1's backward at every ``K1_SHAPES`` shape, and the deduped expand's
   backward (K3) at SIM's full-width item field and two small cases (rows
   shared by two fields; bucket padding), with their times, bounds and
   library yardsticks;
6. train SIM at the same width through ``RankDataLoader`` and
   ``RankModel.fit`` (shuffled train loader, validation), in float32 and
   with ``compute_dtype="bfloat16"``: the loss is finite, every parameter
   moved, each kernel launched exactly as often as the steps and the
   evaluation call it, a step repeated from the same state gives the same
   bits, and a step's gradients and parameters agree with the same step
   through the plain versions; train step ms (CUDA events) and ``fit``
   examples/s;
7. train DCNv2 at ``bench.py``'s shape (26 categorical fields of vocab
   100,000 in one 2,600,000 x 16 table, 13 numeric, batch 8192, parallel
   towers [1024, 512, 256], 4 cross layers) through ``RankModel.multi_step``
   on ``make_synthetic_batch(seed=0)`` stacked K = 10 and placed once, as
   ``bench.py`` drives it, in float32 and with ``compute_dtype="bfloat16"``:
   examples/s and event-timed ms per step over 5 calls after a warm-up;
   TF32 is off; the path launched no K1 or K3 kernel; a K-step call
   repeated from one state gives the same bits; in float32 one step's
   gradients on the card agree with the same step on the CPU;
8. run the port's ``run_expid`` for ``DeepFM_test``, ``DCNv2_test`` and
   ``DCNv2_mix_test`` (``configs/tiny``, on ``data/tiny_parquet``) on the
   card and on the CPU, checkpoints and logs in a temporary directory, and
   hold the card's validation and test AUC and logloss against the CPU's.

Prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a GPU or outside a checkout. ``--profile`` adds a
``torch.profiler`` breakdown by kernel of one SIM forward and of one SIM
train step, per type, and by aten op of one DCNv2 step (forward and
backward, then ``ClippedAdam``), per type.
"""

import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict

import numpy as np
import torch

TOL = 1e-5                       # abs and rel, f32 kernel vs plain version
# bf16 kernel vs the plain version computed in f32 from the same bf16
# inputs: the kernel sums in f32 and rounds its output once, so one bf16
# rounding (relative 2**-8) plus the f32 tolerance of a sum in another order
K1_TOL = {torch.float32: (TOL, TOL), torch.bfloat16: (2 ** -8, TOL)}
# SIM y_pred in bf16, the kernel's run vs a run whose attention is the
# plain version in f32 rounded once, as the kernel computes it: the two
# differ only where f32 sums in another order round an attention output to
# the other bf16 neighbour, and the bf16 layers above carry that step on.
# Measured 2.41e-4 at the full SIM width on an H100 (the f32 and bf16
# paths' predictions differ by 2.6e-3, ten times more)
Y_TOL_BF16 = 3e-4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20       # > 50 MB L2: every timed launch starts cold
SPIN_CYCLES = 2_000_000          # ~1 ms at the H100's clock: the host's lead
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# kernel names in the `kernels` line, per type; f32 keeps the name of the
# first records of each kernel
KERNEL_NAMES = {
    "fwd": {torch.float32: "target_attention",
            torch.bfloat16: "target_attention_bf16"},
    "bwd": {torch.float32: "target_attention_bwd",
            torch.bfloat16: "target_attention_bwd_bf16"},
    "expand_bwd": {torch.float32: "table_gather_expand_bwd",
                   torch.bfloat16: "table_gather_expand_bwd_bf16"},
}
SOURCES = ("target_attention", "table_gather_expand")
# K3 backward against its plain version computed in f64 from the same g:
# the kernel's f32 sums of up to a third of a million rows (1e-5 of the
# largest row), and in bf16 one rounding of the output on top. (In f32 the
# plain version's index_add_ adds with atomics, in another order on each
# run, and is itself that far off: the reference is taken in f64.)
K3_TOL = {torch.float32: TOL, torch.bfloat16: 2 ** -8}

FULL = dict(n_users=60_000, n_items=30_000, n_cates=200, min_len=300,
            max_len=1000, batch=1024, full_batches=4, tail=300,
            embedding_dim=32, attention_dim=64, num_heads=1,
            dnn_hidden_units=[512, 256], short_seq_len=100, topk=100)

K1_SHAPES = [  # (N, L, D, fully masked rows?)
    (1024, 99, 64, False),       # SIM short window: L = short_seq_len - 1
    (1024, 100, 64, False),      # SIM long interest: L = topk
    (2048, 2048, 64, False),
    (1024, 100, 64, True),       # a quarter of the rows fully masked
    (517, 333, 24, True),        # L not a multiple of the tile, odd D
]
MAIN_SHAPE = (1024, 100, 64)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def time_ms(fn, reps=25, warmup=3):
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush, from CUDA events around the launch alone. A spin kernel holds
    the device after the flush while the host enqueues the start event and
    ``fn``'s launches, so that a wrapper's Python work is not counted as
    device time when it outlasts the flush."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def k1_inputs(N, L, D, fully_masked, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(N, D, device="cuda", generator=g)
    k = torch.randn(N, L, D, device="cuda", generator=g)
    v = torch.randn(N, L, D, device="cuda", generator=g)
    mask = (torch.rand(N, L, device="cuda", generator=g) > 0.3).float()
    if fully_masked:
        mask[::4] = 0.0
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


def k1_bound(N, L, D, itemsize):
    """Least time for K1 on the card: q, k, v read and out written once at
    their item size, the f32 mask read once, over the memory rate; or its
    4*N*L*D operations, f32 in both types, over the f32 rate."""
    bytes_moved = itemsize * (2 * N * D + 2 * N * L * D) + 4 * N * L
    flops = 4 * N * L * D
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_target_attention(dtype):
    """K1 against its plain version at every shape in ``dtype``; returns
    per-shape rows and the max abs error."""
    from fuxictr_tpu_torch.ops.target_attention import (
        target_attention_cuda, target_attention_reference)
    rtol, atol = K1_TOL[dtype]
    rows, worst = [], 0.0
    for N, L, D, fully_masked in K1_SHAPES:
        q, k, v, mask = k1_inputs(N, L, D, fully_masked, dtype)
        scale = D ** 0.5
        out = target_attention_cuda(q, k, v, mask, scale)
        ref = target_attention_reference(q.float(), k.float(), v.float(),
                                         mask, scale)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        if out.dtype != dtype or not torch.allclose(out.float(), ref,
                                                    rtol=rtol, atol=atol):
            raise AssertionError(
                f"target_attention {DTYPES[dtype]} N={N} L={L} D={D}: "
                f"{out.dtype}, max abs err {err} exceeds {atol} abs / "
                f"{rtol} rel")
        worst = max(worst, err)
        q4, k4, v4 = q[:, None, None, :], k[:, None], v[:, None]
        m4 = (mask > 0)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bound, bound_by = k1_bound(N, L, D, q.element_size())
        rows.append(OrderedDict(
            dtype=DTYPES[dtype], N=N, L=L, D=D,
            fully_masked_rows=fully_masked, max_abs_err=err,
            ms=time_ms(lambda: target_attention_cuda(q, k, v, mask, scale)),
            plain_ms=time_ms(
                lambda: target_attention_reference(q, k, v, mask, scale)),
            library_ms=time_ms(
                lambda: sdpa(q4, k4, v4, attn_mask=m4, scale=1.0 / scale)),
            bound_ms=bound, bound_by=bound_by))
        print(json.dumps({"target_attention": rows[-1]}), flush=True)
    return rows, worst


def k1_bwd_bound(N, L, D, itemsize):
    """Least time for K1's backward: q, out, dout read and dq written
    ([N, D] each), k, v read and dk, dv written ([N, L, D] each) at their
    item size, the f32 mask and [N, 2] statistics read once, over the
    memory rate; or its 8*N*L*D f32 operations (q.k, dout.v, dv, dk, dq)
    over the f32 rate."""
    bytes_moved = (itemsize * (4 * N * D + 4 * N * L * D) + 4 * N * L
                   + 8 * N)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * N * L * D / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_target_attention_bwd(dtype):
    """K1's backward against its plain version (computed in f32 from the
    same inputs, the forward's out included, and rounded once) at every
    shape in ``dtype``; times kernel, plain version (in ``dtype``) and the
    backward of ``scaled_dot_product_attention``. Returns per-shape rows
    and the max abs error."""
    from fuxictr_tpu_torch.ops.target_attention import (
        target_attention_backward_reference, target_attention_bwd_cuda,
        target_attention_cuda)
    rtol, atol = K1_TOL[dtype]
    rows, worst = [], 0.0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for N, L, D, fully_masked in K1_SHAPES:
        q, k, v, mask = k1_inputs(N, L, D, fully_masked, dtype)
        g = torch.Generator(device="cuda").manual_seed(1)
        dout = torch.randn(N, D, device="cuda", generator=g).to(dtype)
        scale = D ** 0.5
        out, stats = target_attention_cuda(q, k, v, mask, scale,
                                           with_stats=True)
        grads = target_attention_bwd_cuda(q, k, v, mask, out, dout, stats,
                                          scale)
        ref = target_attention_backward_reference(
            q.float(), k.float(), v.float(), mask, scale, dout.float(),
            out=out.float())
        torch.cuda.synchronize()
        err = max(float((a.float() - b).abs().max())
                  for a, b in zip(grads, ref))
        if any(a.dtype != dtype or not torch.allclose(a.float(), b, rtol=rtol,
                                                      atol=atol)
               for a, b in zip(grads, ref)):
            raise AssertionError(
                f"target_attention_bwd {DTYPES[dtype]} N={N} L={L} D={D}: "
                f"max abs err {err} exceeds {atol} abs / {rtol} rel")
        worst = max(worst, err)
        q4, k4, v4 = (t.detach().clone().requires_grad_()
                      for t in (q[:, None, None, :], k[:, None], v[:, None]))
        y4 = sdpa(q4, k4, v4, attn_mask=(mask > 0)[:, None, None, :],
                  scale=1.0 / scale)
        d4 = dout[:, None, None, :]
        bound, bound_by = k1_bwd_bound(N, L, D, q.element_size())
        rows.append(OrderedDict(
            dtype=DTYPES[dtype], N=N, L=L, D=D,
            fully_masked_rows=fully_masked, max_abs_err=err,
            ms=time_ms(lambda: target_attention_bwd_cuda(
                q, k, v, mask, out, dout, stats, scale)),
            plain_ms=time_ms(lambda: target_attention_backward_reference(
                q, k, v, mask, scale, dout, out=out)),
            library_ms=time_ms(lambda: torch.autograd.grad(
                y4, (q4, k4, v4), d4, retain_graph=True)),
            bound_ms=bound, bound_by=bound_by))
        print(json.dumps({"target_attention_bwd": rows[-1]}), flush=True)
    return rows, worst


def expand_bwd_bound(N, U, V, k, D, itemsize, masked):
    """Least time for K3's backward: g [N, k*D] read at its item size, the
    int64 inv [N] and ids [k, U] (and the bool mask) read, dtable [V, D]
    written once, over the memory rate; or its N*k*D f32 additions over
    the f32 rate. The helper sorts are bookkeeping inside the kernel's
    time, not in its bound."""
    bytes_moved = (itemsize * (N * k * D + V * D) + 8 * (N + k * U)
                   + (k * U if masked else 0))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = N * k * D / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def expand_cases(shape, seed):
    """K3's backward inputs: SIM's item_id field in the first batch of the
    full-width loader (real dedup inverse, bucket-padded ids, the 90,002-row
    table), and two small synthetic ones: two fields of one table whose
    rows coincide, with a padding mask; and a large bucket of which few
    slots are used. Each: (name, inv, ids [k, U], mask or None, V, D)."""
    from fuxictr_tpu_torch.data.longctr_loader import (ITEMS_KEY,
                                                       LongCTRDataLoader)
    from fuxictr_tpu_torch.ops.embedding import INVERSE_KEY, EmbeddingLayout
    data, user_seqs, items = make_side_tables(shape, seed)
    fm = sim_feature_map(shape)
    loader = LongCTRDataLoader(fm, data, batch_size=shape["batch"],
                               user_info=user_seqs, item_info=items,
                               max_len=shape["max_len"])
    batch = next(iter(loader))[ITEMS_KEY]
    plan = EmbeddingLayout(fm, shape["embedding_dim"]).fields["item_id"]
    V = EmbeddingLayout(fm, shape["embedding_dim"]).tables[
        plan["table"]]["rows"]
    cases = [("sim_item_id", batch[INVERSE_KEY].astype(np.int64),
              (batch["item_id"] + plan["offset"])[None].astype(np.int64),
              None, V, shape["embedding_dim"])]
    rng = np.random.default_rng(seed)
    for name, N, U, used, V, k in (("shared_rows", 200_000, 8192, 6000,
                                    5000, 2),
                                   ("bucket_padding", 50_000, 16384, 3000,
                                    100_000, 1)):
        inv = rng.integers(0, used, N)
        ids = np.zeros((k, U), np.int64)
        ids[:, :used] = rng.integers(0, V, (k, used))
        mask = np.zeros((k, U), bool)
        mask[:, :used] = rng.random((k, used)) > 0.1
        cases.append((name, inv, ids, mask if k > 1 else None, V,
                      shape["embedding_dim"]))
    return cases


def check_expand_bwd(dtype, cases):
    """K3's backward against its plain version (computed in f64 from the
    same g) per case in ``dtype``, two launches bitwise
    equal; times kernel (its helper sorts included), plain version (in
    ``dtype``) and the autograd backward of ``table[ids][inv]``. Returns
    per-case rows and the max abs error."""
    from fuxictr_tpu_torch.ops.embedding import (
        table_gather_expand_bwd_cuda, table_gather_expand_bwd_reference)
    rows, worst = [], 0.0
    for name, inv, ids, mask, V, D in cases:
        k, U = ids.shape
        N = inv.shape[0]
        g = torch.Generator(device="cuda").manual_seed(2)
        grad = torch.randn(N, k * D, device="cuda", generator=g).to(dtype)
        inv_t, ids_t = (torch.from_numpy(a).cuda() for a in (inv, ids))
        mask_t = None if mask is None else torch.from_numpy(mask).cuda()
        out = table_gather_expand_bwd_cuda(grad, inv_t, ids_t, mask_t, V)
        again = table_gather_expand_bwd_cuda(grad, inv_t, ids_t, mask_t, V)
        ref = table_gather_expand_bwd_reference(grad.double(), inv_t, ids_t,
                                                mask_t, V)
        torch.cuda.synchronize()
        err = float((out.double() - ref).abs().max())
        atol = TOL * float(ref.abs().max())
        if not torch.equal(out, again) or out.dtype != dtype \
                or not torch.allclose(out.double(), ref, rtol=K3_TOL[dtype],
                                      atol=atol):
            raise AssertionError(
                f"table_gather_expand_bwd {DTYPES[dtype]} {name}: max abs "
                f"err {err} (limit {atol} abs / {K3_TOL[dtype]} rel), or "
                f"two launches differ")
        worst = max(worst, err)
        table = torch.zeros(V, D, dtype=dtype, device="cuda",
                            requires_grad=True)
        y = (table[ids_t[0]][inv_t] if mask_t is None else torch.cat(
            [table[ids_t[i]] * mask_t[i][:, None].to(dtype)
             for i in range(k)], dim=-1)[inv_t])
        bound, bound_by = expand_bwd_bound(N, U, V, k, D,
                                           grad.element_size(),
                                           mask is not None)
        rows.append(OrderedDict(
            dtype=DTYPES[dtype], case=name, N=N, U=U,
            used=int(np.unique(inv).size), V=V, k=k, D=D, max_abs_err=err,
            ms=time_ms(lambda: table_gather_expand_bwd_cuda(
                grad, inv_t, ids_t, mask_t, V)),
            plain_ms=time_ms(lambda: table_gather_expand_bwd_reference(
                grad, inv_t, ids_t, mask_t, V)),
            library_ms=time_ms(lambda: torch.autograd.grad(
                y, table, grad, retain_graph=True)),
            bound_ms=bound, bound_by=bound_by))
        print(json.dumps({"table_gather_expand_bwd": rows[-1]}), flush=True)
    return rows, worst


def make_side_tables(shape, seed):
    """Seeded synthetic LongCTR tables: lifelong user histories of
    ``min_len..max_len`` items, an item table with ``item_id`` and
    ``cate_id``, and ``full_batches`` batches plus a partial one of
    interactions with random clicks."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(shape["min_len"], shape["max_len"] + 1,
                        shape["n_users"])
    flat = rng.integers(1, shape["n_items"] + 1, int(lens.sum()))
    user_seqs = np.split(flat, np.cumsum(lens)[:-1])
    n_rows = shape["n_items"] + 1
    items = {"item_index": np.arange(n_rows), "item_id": np.arange(n_rows),
             "cate_id": np.concatenate(
                 [[0], rng.integers(1, shape["n_cates"] + 1, n_rows - 1)])}
    n = shape["full_batches"] * shape["batch"] + shape["tail"]
    users = rng.integers(0, shape["n_users"], n)
    data = {"user_index": users, "seq_len": lens[users],
            "item_index": rng.integers(1, shape["n_items"] + 1, n),
            "user_feat": users + 1,
            "clk": (rng.random(n) < 0.3).astype(np.float32)}
    return data, user_seqs, items


def sim_feature_map(shape):
    from fuxictr_tpu_torch.features import FeatureMap
    fm = FeatureMap("sim_synthetic")
    cat = {"type": "categorical", "padding_idx": 0}
    fm.features = OrderedDict([
        ("user_feat", dict(cat, source="user",
                           vocab_size=shape["n_users"] + 1)),
        ("item_id", dict(cat, source="item",
                         vocab_size=shape["n_items"] + 1)),
        ("cate_id", dict(cat, source="item",
                         vocab_size=shape["n_cates"] + 1)),
    ])
    fm.labels = ["clk"]
    fm.num_fields = fm.get_num_fields()
    fm.set_column_index()
    return fm


def plain_in_f32(q, k, v, mask, scale):
    """K1's plain version computed in f32 from q, k, v and rounded once to
    their type, as the kernel computes it (its sums in another order)."""
    from fuxictr_tpu_torch.ops.target_attention import \
        target_attention_reference
    return target_attention_reference(q.float(), k.float(), v.float(), mask,
                                      scale).to(q.dtype)


@contextlib.contextmanager
def plain_attention(model):
    """``model`` with every target attention forced to the plain version
    (computed in f32, :func:`plain_in_f32`)."""
    from fuxictr_tpu_torch.ops.attention import MultiHeadTargetAttention
    mods = [m for m in model.modules()
            if isinstance(m, MultiHeadTargetAttention)]
    saved = [m.attention_fn for m in mods]
    for m in mods:
        m.attention_fn = plain_in_f32
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.attention_fn = fn


def serve_sim(device, shape, compute_dtype=None, seed=2019, profile=False):
    """SIM predict + evaluate on ``device`` with ``compute_dtype``; returns
    the report, the main path's launch counts and the predictions."""
    from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader
    from fuxictr_tpu_torch.metrics import evaluate_metrics
    from fuxictr_tpu_torch.models import get_model
    from fuxictr_tpu_torch.ops.target_attention import target_attention_cuda
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    data, user_seqs, items = make_side_tables(shape, seed)
    fm = sim_feature_map(shape)
    loader = LongCTRDataLoader(fm, data, batch_size=shape["batch"],
                               user_info=user_seqs, item_info=items,
                               max_len=shape["max_len"])
    t1 = time.perf_counter()
    batches = list(loader)
    t2 = time.perf_counter()
    model = get_model("SIM")(
        fm, embedding_dim=shape["embedding_dim"],
        attention_dim=shape["attention_dim"], num_heads=shape["num_heads"],
        dnn_hidden_units=shape["dnn_hidden_units"],
        short_seq_len=shape["short_seq_len"], topk=shape["topk"],
        compute_dtype=compute_dtype, device=device, seed=seed)
    # the training init of the tables (std 1e-4) leaves every prediction at
    # 0.5 and would hide an attention error: redraw them at std 0.5
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for table in model.embedding.parameters():
            table.copy_(torch.randn(table.shape, generator=g) * 0.5)
    model.predict(batches[:1])                      # warm-up
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # the main path: what a user calls, through the loader
    sync()
    target_attention_cuda.launches = 0
    t3 = time.perf_counter()
    y = model.predict(loader)
    sync()
    t4 = time.perf_counter()
    logs = model.evaluate(loader, ["AUC", "logloss"])
    launches = {"target_attention": target_attention_cuda.launches}

    n = loader.num_samples
    if y.shape != (n,) or not np.all(np.isfinite(y)) \
            or not np.all((y >= 0) & (y <= 1)):
        raise AssertionError(f"predict gave {y.shape} values, expected "
                             f"{n} finite probabilities")
    expect = evaluate_metrics(data["clk"].astype(np.float64), y,
                              ["AUC", "logloss"])
    for key in expect:
        if not np.isfinite(logs[key]) or abs(logs[key] - expect[key]) > 1e-6:
            raise AssertionError(f"evaluate {key}={logs[key]} but the "
                                 f"predictions give {expect[key]}")

    sync()
    t5 = time.perf_counter()
    y_again = model.predict(batches)
    sync()
    t6 = time.perf_counter()
    with plain_attention(model):
        y_plain = model.predict(batches)
    diff = float(np.abs(y_again - y_plain).max())
    limit = TOL if compute_dtype is None else Y_TOL_BF16
    if diff > limit or not np.array_equal(y, y_again):
        raise AssertionError(
            f"SIM y_pred with the kernel differs from the plain attention "
            f"by {diff} (limit {limit}), or between two runs")

    report = OrderedDict(
        compute_dtype=compute_dtype or "float32",
        rows=n, batches=len(batches), batch_size=shape["batch"],
        max_len=shape["max_len"], tables_s=t1 - t0,
        collate_ms_per_batch=(t2 - t1) * 1e3 / len(batches),
        predict_rows_per_s=n / (t4 - t3),
        predict_ms_per_batch=(t4 - t3) * 1e3 / len(batches),
        precollated_predict_rows_per_s=n / (t6 - t5),
        precollated_predict_ms_per_batch=(t6 - t5) * 1e3 / len(batches),
        AUC=logs["AUC"], logloss=logs["logloss"], y_pred_std=float(y.std()),
        max_abs_diff_vs_plain_attention=diff)
    if on_card:
        placed = [model._place_batch(b) for b in batches]
        forward = lambda: [model.compute_forward(b) for b in placed]
        with torch.no_grad():
            report["forward_ms_per_batch"] = time_ms(
                forward, reps=5, warmup=1) / len(placed)
            with plain_attention(model):
                report["plain_attention_forward_ms_per_batch"] = time_ms(
                    forward, reps=5, warmup=1) / len(placed)
            if profile:
                report["profile"] = profile_forward(model, placed[0])
    return report, launches, y


def profile_forward(model, batch, top=12):
    """Device time of one SIM forward by kernel name (torch.profiler), and
    K1's share of it (its two launches, with k and v fresh from W_k/W_v)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model.compute_forward(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.compute_forward(batch)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in events)
    k1 = [e for e in events if "target_attention" in e.key]
    events.sort(key=lambda e: -e.device_time_total)
    return {"device_ms": total / 1e3,
            "target_attention_ms": sum(e.device_time_total for e in k1) / 1e3,
            "target_attention_calls": sum(e.count for e in k1),
            "kernels": [[e.key[:80], e.device_time_total / 1e3, e.count]
                        for e in events[:top]]}


def _plain_forward(q, k, v, mask, scale, with_stats=False):
    out = plain_in_f32(q, k, v, mask, scale)
    return (out, None) if with_stats else out


def _plain_backward(q, k, v, mask, out, dout, stats, scale):
    from fuxictr_tpu_torch.ops.target_attention import \
        target_attention_backward_reference
    grads = target_attention_backward_reference(
        q.float(), k.float(), v.float(), mask, scale, dout.float(),
        out=out.float())
    return tuple(g.to(q.dtype) for g in grads)


def _plain_expand_backward(g, inv, ids_stack, mask_stack, num_rows):
    from fuxictr_tpu_torch.ops.embedding import \
        table_gather_expand_bwd_reference
    return table_gather_expand_bwd_reference(
        g.float(), inv, ids_stack, mask_stack, num_rows).to(g.dtype)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of the training path swapped for its plain
    version, computed in f32 from the same inputs and rounded once to
    their type, as the kernels compute."""
    from fuxictr_tpu_torch.ops import embedding as emb
    from fuxictr_tpu_torch.ops import target_attention as ta
    swaps = [(ta, "target_attention_cuda", _plain_forward),
             (ta, "target_attention_bwd_cuda", _plain_backward),
             (emb, "table_gather_expand_bwd_cuda", _plain_expand_backward)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def snapshot(model):
    """The model's parameters, buffers and optimizer state, copied."""
    opt = model._optimizer
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [m.clone() for m in opt.mu], [n.clone() for n in opt.nu],
            opt.count, opt.lr)


def restore(model, snap):
    state, mu, nu, count, lr = snap
    model.load_state_dict(state)
    opt = model._optimizer
    for dst, src in zip(opt.mu + opt.nu, mu + nu):
        dst.copy_(src)
    opt.count, opt.lr = count, lr


# A train step's gradients with every kernel against the same step with
# the plain versions, each tensor's max abs difference over its largest
# entry: in f32 sums in another order (the table's rows sum up to a third
# of a million positions); in bf16 the kernels' and the plain versions'
# outputs differ by one bf16 rounding where f32 sums in another order
# round the other way, and the bf16 layers below carry that on. Measured
# on an H100: 4.3e-7 (f32) and 4.3e-3 (bf16).
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# ... the parameters after one Adam step from the post-fit state on those
# gradients, max abs difference (measured 1.2e-7 and 3.0e-6); Adam divides
# by the gradients' running scale, so this is checked on parameters too
PARAM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# ... and the step's loss, relative: f32 sums in another order; in bf16 the
# attention outputs differ as in serving (Y_TOL_BF16)
LOSS_TOL = {torch.float32: TOL, torch.bfloat16: Y_TOL_BF16}


def train_sim(device, shape, compute_dtype=None, seed=2019, profile=False):
    """SIM trained through ``RankDataLoader`` and ``fit`` on ``device``;
    returns the report and the launch counts of the ``fit`` run."""
    from fuxictr_tpu_torch.data.loader import RankDataLoader
    from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader
    from fuxictr_tpu_torch.models import get_model
    from fuxictr_tpu_torch.ops import embedding as emb
    from fuxictr_tpu_torch.ops import target_attention as ta
    dtype = torch.bfloat16 if compute_dtype else torch.float32
    data, user_seqs, items = make_side_tables(shape, seed)
    # train: two full batches and the partial one; valid: the rest
    n_train = 2 * shape["batch"] + shape["tail"]
    train_data = {c: a[:n_train] for c, a in data.items()}
    valid_data = {c: a[n_train:] for c, a in data.items()}
    fm = sim_feature_map(shape)
    train_gen, valid_gen = RankDataLoader(
        fm, stage="train", train_data=train_data, valid_data=valid_data,
        batch_size=shape["batch"], shuffle=True,
        data_loader=LongCTRDataLoader, user_info=user_seqs, item_info=items,
        max_len=shape["max_len"], seed=seed).make_iterator()
    ckpt_dir = tempfile.TemporaryDirectory()
    model = get_model("SIM")(
        fm, embedding_dim=shape["embedding_dim"],
        attention_dim=shape["attention_dim"], num_heads=shape["num_heads"],
        dnn_hidden_units=shape["dnn_hidden_units"],
        short_seq_len=shape["short_seq_len"], topk=shape["topk"],
        compute_dtype=compute_dtype, device=device, seed=seed,
        model_root=ckpt_dir.name)
    # spread the tables as serve_sim does, so that attention is not uniform
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for table in model.embedding.parameters():
            table.copy_(torch.randn(table.shape, generator=g) * 0.5)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = []
    step = model.train_step
    model.train_step = lambda batch: losses.append(step(batch)) or losses[-1]

    # the main path: what a user calls, through the loaders
    torch.cuda.synchronize()
    ta.target_attention_cuda.launches = 0
    ta.target_attention_bwd_cuda.launches = 0
    emb.table_gather_expand_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    model.fit(train_gen, validation_data=valid_gen, epochs=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"fwd": ta.target_attention_cuda.launches,
                "bwd": ta.target_attention_bwd_cuda.launches,
                "expand_bwd": emb.table_gather_expand_bwd_cuda.launches}
    del model.train_step

    steps = len(train_gen)
    expected = {"fwd": 2 * steps + 2 * len(valid_gen), "bwd": 2 * steps,
                "expand_bwd": 2 * steps}
    if launches != expected:
        raise AssertionError(f"SIM training in {DTYPES[dtype]} launched "
                             f"{launches}, expected {expected}")
    loss_values = [float(x) for x in losses]
    if len(loss_values) != steps or not np.all(np.isfinite(loss_values)):
        raise AssertionError(f"train losses {loss_values}")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p, before[n])]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    if not os.path.exists(model.checkpoint):
        raise AssertionError("fit saved no best weights")

    # a step twice from one state: the same bits
    placed = [model._place_batch(b) for b in valid_gen]
    snap = snapshot(model)
    model.train_step(placed[0])
    first = [p.detach().clone() for p in model.parameters()]
    restore(model, snap)
    model.train_step(placed[0])
    if not all(torch.equal(a, b) for a, b in zip(first, model.parameters())):
        raise AssertionError("two train steps from one state differ")

    # the same step with the plain versions: gradients and parameters
    restore(model, snap)
    loss_k, grads_k = model.loss_and_grads(placed[0])
    with plain_kernels():
        loss_p, grads_p = model.loss_and_grads(placed[0])
    # torch's max, not Python's: a NaN must show, and fail the checks
    grad_err = float(torch.stack([
        (a - b).abs().max() / b.abs().max().clamp(min=1e-30)
        for a, b in zip(grads_k, grads_p)]).max())
    model._optimizer.step(grads_k)
    kernel_params = [p.detach().clone() for p in model.parameters()]
    restore(model, snap)
    model._optimizer.step(grads_p)
    param_err = float(torch.stack([
        (a - b).abs().max()
        for a, b in zip(kernel_params, model.parameters())]).max())
    restore(model, snap)
    if not (grad_err <= GRAD_TOL[dtype] and param_err <= PARAM_TOL[dtype]
            and abs(float(loss_k) - float(loss_p))
            <= LOSS_TOL[dtype] * abs(float(loss_p))):
        raise AssertionError(
            f"SIM train step in {DTYPES[dtype]}: gradients with the kernels "
            f"differ from the plain versions' by {grad_err} of the largest "
            f"(limit {GRAD_TOL[dtype]}), parameters by {param_err} (limit "
            f"{PARAM_TOL[dtype]}), loss {float(loss_k)} vs {float(loss_p)}")

    # train step time over placed batches, CUDA events
    train_placed = [model._place_batch(b) for b in train_gen]
    model.train_step(train_placed[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in train_placed:
        model.train_step(b)
    end.record()
    torch.cuda.synchronize()
    n_rows = len(train_data["clk"])
    report = OrderedDict(
        compute_dtype=compute_dtype or "float32", train_rows=n_rows,
        train_batches=steps, valid_batches=len(valid_gen),
        batch_size=shape["batch"], launches=launches,
        losses=loss_values,
        fit_s=t1 - t0, fit_examples_per_s=n_rows / (t1 - t0),
        train_window_examples_per_s=model._window_rates[-1],
        train_step_ms=start.elapsed_time(end) / len(train_placed),
        grad_max_rel_diff_vs_plain=grad_err,
        param_max_abs_diff_vs_plain=param_err,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if profile:
        report["profile"] = profile_train_step(model, train_placed[0])
    ckpt_dir.cleanup()
    return report, launches


def profile_train_step(model, batch, top=14):
    """Device time of one SIM train step by kernel name (torch.profiler),
    and the shares of K1's forward and backward and K3's backward."""
    from torch.profiler import ProfilerActivity, profile
    model.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    host = sorted((e for e in averages if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    events = [e for e in averages
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in events)
    events.sort(key=lambda e: -e.device_time_total)

    def share(*names):
        return sum(e.device_time_total for e in events
                   if any(n in e.key for n in names)) / 1e3

    return {"wall_ms": wall * 1e3, "device_ms": total / 1e3,
            "host_ops": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                         for e in host[:top]],
            "k1_fwd_ms": share("target_attention_fwd_kernel"),
            "k1_bwd_ms": share("target_attention_bwd_kernel"),
            "k3_bwd_ms": share("slot_bounds_kernel", "tile_sums_kernel",
                               "row_sums_kernel"),
            "kernels": [[e.key[:80], e.device_time_total / 1e3, e.count]
                        for e in events[:top]]}


# DCNv2 at bench.py's shape (bench.py:30-46): 26 categorical fields of
# vocab 100,000 (one fused 2,600,000 x 16 table) and 13 numeric, batch
# 8192, parallel structure, towers [1024, 512, 256], 4 cross layers; the
# batch from make_synthetic_batch(seed=0) stacked K = 10 and placed once
DCNV2 = dict(num_categorical=26, num_numeric=13, vocab_size=100_000,
             embedding_dim=16, batch=8192, steps_per_call=10, timed_calls=5,
             hidden_units=[1024, 512, 256], num_cross_layers=4)
# One f32 step's gradients on the card against the same step on the CPU
# (same parameters and batch, the same side of every ReLU), each tensor's
# max abs difference over its largest entry: the devices sum in other
# orders, and a weight gradient sums 8192 products, whose f32 rounding in
# another order is ~sqrt(8192) * 2**-24 = 5e-6 of the sum. Measured on an
# H100, on the freshly built model with the ReLU sides pinned: 8.8e-7
CARD_CPU_GRAD_TOL = 5e-5
CARD_CPU_LOSS_TOL = 1e-5         # relative: f32 sums in another order


def dcnv2_model(device, compute_dtype, model_root, seed=2019):
    from fuxictr_tpu_torch.models import get_model
    from fuxictr_tpu_torch.utils.synthetic import make_synthetic_feature_map
    fm = make_synthetic_feature_map(
        num_categorical=DCNV2["num_categorical"],
        num_numeric=DCNV2["num_numeric"], vocab_size=DCNV2["vocab_size"],
        embedding_dim=DCNV2["embedding_dim"])
    model = get_model("DCNv2")(
        fm, model_id="DCNv2_bench", embedding_dim=DCNV2["embedding_dim"],
        model_structure="parallel",
        stacked_dnn_hidden_units=DCNV2["hidden_units"],
        parallel_dnn_hidden_units=DCNV2["hidden_units"],
        num_cross_layers=DCNV2["num_cross_layers"],
        compute_dtype=compute_dtype, device=device, seed=seed,
        model_root=model_root)
    return model, fm


def train_dcnv2(device, compute_dtype=None, profile=False):
    """DCNv2 at bench.py's shape through ``RankModel.multi_step`` on the
    card: one warm-up call, then ``timed_calls`` calls of K steps, the loss
    read at the end as the barrier; asserts that TF32 is off, that the path
    launched no K1 or K3 kernel, that a K-step call repeated from one state
    gives the same bits, and (f32) that one step's gradients agree with the
    same step on the CPU. Returns the report."""
    from fuxictr_tpu_torch.ops import embedding as emb
    from fuxictr_tpu_torch.ops import target_attention as ta
    from fuxictr_tpu_torch.utils.synthetic import make_synthetic_batch
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("f32 products must not run in TF32: the JAX "
                             "reference computes them in f32")
    dtype = torch.bfloat16 if compute_dtype else torch.float32
    ckpt_dir = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    model, fm = dcnv2_model(device, compute_dtype, ckpt_dir.name)
    batch = make_synthetic_batch(fm, batch_size=DCNV2["batch"], seed=0)
    k = DCNV2["steps_per_call"]
    stacked = model._place_batch({key: np.stack([v] * k)
                                  for key, v in batch.items()})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    one = {key: v[0] for key, v in stacked.items()}
    checks = (card_vs_cpu_step(model, one, ckpt_dir.name)
              if compute_dtype is None else {})

    # the main path: bench.py's loop
    ta.target_attention_cuda.launches = 0
    ta.target_attention_bwd_cuda.launches = 0
    emb.table_gather_expand_bwd_cuda.launches = 0
    warm = float(model.multi_step(stacked))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    for _ in range(DCNV2["timed_calls"]):
        loss = model.multi_step(stacked)
    end.record()
    loss = float(loss)
    t2 = time.perf_counter()
    launches = {"target_attention": ta.target_attention_cuda.launches,
                "target_attention_bwd": ta.target_attention_bwd_cuda.launches,
                "table_gather_expand_bwd":
                    emb.table_gather_expand_bwd_cuda.launches}
    if any(launches.values()):
        raise AssertionError(f"DCNv2 launched {launches}: its path has no "
                             f"K1 or K3 kernel")
    steps = DCNV2["timed_calls"] * k
    if not (np.isfinite(warm) and np.isfinite(loss)):
        raise AssertionError(f"DCNv2 losses {warm}, {loss}")

    # a K-step call twice from one state: the same bits
    snap = snapshot(model)
    loss_a = model.multi_step(stacked)
    params_a = [p.detach().clone() for p in model.parameters()]
    restore(model, snap)
    loss_b = model.multi_step(stacked)
    if not (torch.equal(loss_a, loss_b) and all(
            torch.equal(a, b) for a, b in zip(params_a, model.parameters()))):
        raise AssertionError(f"DCNv2 in {DTYPES[dtype]}: two {k}-step calls "
                             f"from one state differ")
    restore(model, snap)

    report = OrderedDict(
        compute_dtype=compute_dtype or "float32", batch_size=DCNV2["batch"],
        steps_per_call=k, timed_steps=steps,
        table_rows=model.embedding.table_d16.shape[0],
        build_and_place_s=build_s, loss_after_warmup=warm, loss=loss,
        examples_per_s=steps * DCNV2["batch"] / (t2 - t1),
        train_step_ms=start.elapsed_time(end) / steps,
        launches=launches, bitwise_repeatable=True,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    report.update(checks)
    if compute_dtype is not None:
        table = model.embedding.table_d16.detach()
        report["table_cast_ms"] = time_ms(
            lambda: table.to(torch.bfloat16), reps=10, warmup=2)
        report["table_cast_bound_ms"] = (table.numel() * 6
                                         / HBM_BYTES_PER_S * 1e3)
    if profile:
        report["profile"] = profile_dcnv2_step(model, one)
    ckpt_dir.cleanup()
    return report


def _tower_hooks(model, pin=None):
    """Forward hooks on the parallel tower's hidden Dense layers (the ReLU
    inputs) that keep their outputs; with ``pin`` (the same outputs from
    the other device), an output on the other side of zero from its
    ``pin`` value takes that value, so that both devices take the same
    side of every ReLU. Returns the kept outputs, the number of values
    moved, and the hook handles."""
    kept, moved, tower = [], [0], model.parallel_dnn

    def hook(i):
        def keep(mod, args, out):
            if pin is not None:
                ref = pin[i].to(out.device)
                flip = (ref > 0) != (out > 0)
                moved[0] += int(flip.sum())
                out = out + ((ref - out) * flip).detach()
            kept.append(out.detach())
            return out
        return keep
    handles = [getattr(tower, f"Dense_{i}").register_forward_hook(hook(i))
               for i in range(tower._n_hidden)]
    return kept, moved, handles


def card_vs_cpu_step(model, batch, model_root):
    """One f32 step's loss and gradients on the card and on the CPU, from
    the card model's parameters and the same batch. A ReLU input within
    f32 rounding of zero may fall on one side on the card and on the
    other on the CPU, and then one example's term of a weight gradient is
    in one sum and not the other (3 such inputs of 14.7 million moved the
    table's gradient by 0.8% of its largest entry): the CPU step takes
    the card's side of each ReLU (:func:`_tower_hooks`), and the count of
    inputs moved is reported."""
    cpu_model, _ = dcnv2_model(torch.device("cpu"), None, model_root)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    kept, _, hooks = _tower_hooks(model)
    loss_g, grads_g = model.loss_and_grads(batch)
    _, moved, cpu_hooks = _tower_hooks(cpu_model, pin=kept)
    loss_c, grads_c = cpu_model.loss_and_grads(
        {k: v.cpu() for k, v in batch.items()})
    for h in hooks + cpu_hooks:
        h.remove()
    names = [n for n, _ in model.named_parameters()]
    errs = {n: float((a.cpu() - b).abs().max()
                     / b.abs().max().clamp(min=1e-30))
            for n, a, b in zip(names, grads_g, grads_c)}
    worst = max(errs.values())
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    if not (worst <= CARD_CPU_GRAD_TOL and loss_err <= CARD_CPU_LOSS_TOL):
        raise AssertionError(
            f"DCNv2 f32 step, card vs CPU: gradients differ by up to {worst} "
            f"of the largest entry (limit {CARD_CPU_GRAD_TOL}; {errs}), "
            f"loss by {loss_err} (limit {CARD_CPU_LOSS_TOL})")
    return {"card_vs_cpu_grad_max_rel": worst,
            "card_vs_cpu_grad_rel": errs,
            "card_vs_cpu_loss_rel": loss_err,
            "card_vs_cpu_relu_inputs_moved": moved[0]}


def _device_ops(prof):
    """Self device time (ms) and calls by aten op, largest first: each
    kernel's time under the op that launched it; and the busy time, the
    kernels' time summed."""
    averages = prof.key_averages()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in averages
           if e.device_type == torch.autograd.DeviceType.CPU
           and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.device_time_total for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return sorted(ops, key=lambda o: -o[1]), busy


def profile_dcnv2_step(model, batch, top=12):
    """Device time of one DCNv2 train step (torch.profiler): the forward
    and backward, then ``ClippedAdam``'s step, each by aten op (the
    kernels' self time under the op that launched them), with each op's
    share of the step's busy time, and the wall time of the profiled
    step."""
    from torch.profiler import ProfilerActivity, profile
    model.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as fwd_bwd:
        loss, grads = model.loss_and_grads(batch)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as adam:
        model._optimizer.step(grads)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (ops, busy_fb), (adam_ops, busy_adam) = (_device_ops(fwd_bwd),
                                             _device_ops(adam))
    total = busy_fb + busy_adam
    if not total > 0:
        raise AssertionError("the profiler saw no device time")

    def share(*names):
        ms = sum(o[1] for o in ops if o[0] in names)
        return {"ms": ms, "share": ms / total}

    return {
        "wall_ms": wall * 1e3, "device_ms": total,
        "forward_backward_ms": busy_fb, "clipped_adam_ms": busy_adam,
        "clipped_adam_share": busy_adam / total,
        "gather (aten::index)": share("aten::index"),
        "scatter backward (aten::index_put_)": share(
            "aten::index_put_", "aten::_index_put_impl_"),
        "casts (aten::_to_copy, aten::copy_)": share("aten::_to_copy",
                                                     "aten::copy_"),
        "gemms (aten::mm, addmm, bmm)": share("aten::mm", "aten::addmm",
                                              "aten::bmm"),
        "top_ops": [[name, ms, ms / total, n] for name, ms, n in sorted(
            ops + [("adam: " + o[0],) + o[1:] for o in adam_ops],
            key=lambda o: -o[1])[:top]]}


# Phase 8: run_expid on configs/tiny over data/tiny_parquet
EXPIDS = ("DeepFM_test", "DCNv2_test", "DCNv2_mix_test")
# validation and test AUC and logloss, card vs CPU: one Adam step from the
# same init on 100 rows, f32 sums in another order
EXPID_TOL = 1e-5


def run_expids(root):
    """The port's ``run_expid`` for each tiny expid on the card and on the
    CPU, checkpoints and logs in a temporary directory; returns the card's
    results and their largest difference from the CPU's."""
    from fuxictr_tpu_torch.config import load_config
    from fuxictr_tpu_torch.experiment import run_expid
    data_root = os.path.join(root, "data")
    out = OrderedDict()
    with tempfile.TemporaryDirectory() as tmp:
        for expid in EXPIDS:
            params = load_config(os.path.join(root, "configs", "tiny"),
                                 expid)
            ds = params["dataset_id"]
            params.update(data_root=data_root + os.sep, **{
                f"{s}_data": os.path.join(data_root, ds, f"{s}.parquet")
                for s in ("train", "valid", "test")})
            runs = {}
            for device in ("cuda", "cpu"):
                result = run_expid(None, expid, params=dict(
                    params, model_root=os.path.join(tmp, device)),
                    device=device)
                if result["model"].device.type != device:
                    raise AssertionError(f"{expid} ran on "
                                         f"{result['model'].device}")
                runs[device] = {s: dict(result[s]) for s in ("valid",
                                                             "test")}
            diff = max(abs(runs["cuda"][s][m] - runs["cpu"][s][m])
                       for s in ("valid", "test") for m in ("AUC",
                                                            "logloss"))
            if not (diff <= EXPID_TOL and all(
                    np.isfinite(v) for s in runs["cuda"].values()
                    for v in s.values())):
                raise AssertionError(f"run_expid {expid}: card {runs['cuda']}"
                                     f" vs CPU {runs['cpu']} (limit "
                                     f"{EXPID_TOL})")
            out[expid] = dict(runs["cuda"], max_abs_diff_vs_cpu=diff)
    return out


def ptxas_report(log_path):
    """Registers, stack and spills of each kernel instance from a build's
    ``-Xptxas -v`` log, keyed by kernel and its template arguments, as
    ``target_attention_fwd_kernel f32 bulk stats`` or
    ``target_attention_bwd_kernel bf16 vec16 G8x1``."""
    report, key = OrderedDict(), None
    with open(log_path) as fd:
        for line in fd:
            if "Compiling entry function" in line:
                name = re.search(r"\d+([a-z_]+_kernel)", line).group(1)
                parts = [name]
                if f"{name}I" in line:          # templated on the type
                    parts.append("bf16" if "__nv_bfloat16" in line else "f32")
                flags = re.search(r"Lb([01])ELb([01])E", line)
                if flags:
                    parts += [("bulk" if flags.group(1) == "1" else "plain")
                              + (" stats" if flags.group(2) == "1" else "")]
                # K1's backward: access form, lanes per position, chunks a lane
                group = re.search(r"Lb([01])ELi(\d+)ELi(\d+)E", line)
                if group:
                    parts += [("vec16" if group.group(1) == "1" else "plain")
                              + f" G{group.group(2)}x{group.group(3)}"]
                key = " ".join(parts)
                report[key] = []
            elif key and ("registers" in line or "spill" in line):
                report[key].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in report.items()}


def kernel_entry(kind, dtype, launches, worst, row, source, replaces):
    return OrderedDict(
        name=KERNEL_NAMES[kind][dtype], dtype=DTYPES[dtype], route="cuda",
        source=source, replaces=replaces, launches=launches,
        max_abs_err=worst, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=row["library_ms"])


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fuxictr_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    profile = "--profile" in argv

    card = card_identity()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    print(json.dumps({"build": {
        "sources": {n: os.path.relpath(so) for n, so in libs.items()},
        "seconds": time.perf_counter() - t0}}))
    for name, so in libs.items():
        print(json.dumps({"ptxas": {name: ptxas_report(so + ".log")}}),
              flush=True)
    k1 = {dt: check_target_attention(dt) for dt in DTYPES}

    served, kernels = {}, []
    for dtype, compute_dtype in ((torch.float32, None),
                                 (torch.bfloat16, "bfloat16")):
        report, launches, y = serve_sim(device, FULL, compute_dtype,
                                        profile=profile)
        print(json.dumps({"sim_serving": report}), flush=True)
        # two MultiHeadTargetAttention calls per forward, predict + evaluate
        expected = 2 * 2 * report["batches"]
        if launches["target_attention"] != expected:
            raise AssertionError(
                f"SIM serving in {report['compute_dtype']} launched "
                f"target_attention {launches['target_attention']} times, "
                f"expected {expected}")
        served[dtype] = y
        rows, worst = k1[dtype]
        main_row = next(r for r in rows if (r["N"], r["L"], r["D"])
                        == MAIN_SHAPE and not r["fully_masked_rows"])
        kernels.append(kernel_entry(
            "fwd", dtype, launches["target_attention"], worst, main_row,
            "fuxictr_tpu_torch/ops/csrc/target_attention.cu",
            "fuxictr_tpu/ops/pallas_kernels.py:109"))
    # the bf16 path must really compute in bf16: its predictions differ
    # from the f32 path's
    gap = float(np.abs(served[torch.bfloat16] - served[torch.float32]).max())
    print(json.dumps({"sim_bf16_vs_f32_max_abs": gap}), flush=True)
    if not gap > 0.0:
        raise AssertionError("SIM served with compute_dtype='bfloat16' gave "
                             "the float32 predictions")

    k1_bwd = {dt: check_target_attention_bwd(dt) for dt in DTYPES}
    cases = expand_cases(FULL, seed=2019)
    k3_bwd = {dt: check_expand_bwd(dt, cases) for dt in DTYPES}

    for dtype, compute_dtype in ((torch.float32, None),
                                 (torch.bfloat16, "bfloat16")):
        report, launches = train_sim(device, FULL, compute_dtype,
                                     profile=profile)
        print(json.dumps({"sim_training": report}), flush=True)
        rows, worst = k1_bwd[dtype]
        main_row = next(r for r in rows if (r["N"], r["L"], r["D"])
                        == MAIN_SHAPE and not r["fully_masked_rows"])
        kernels.append(kernel_entry(
            "bwd", dtype, launches["bwd"], worst, main_row,
            "fuxictr_tpu_torch/ops/csrc/target_attention.cu",
            "autodiff of fuxictr_tpu/ops/pallas_kernels.py:25-30"))
        rows, worst = k3_bwd[dtype]
        kernels.append(kernel_entry(
            "expand_bwd", dtype, launches["expand_bwd"], worst,
            next(r for r in rows if r["case"] == "sim_item_id"),
            "fuxictr_tpu_torch/ops/csrc/table_gather_expand.cu",
            "fuxictr_tpu/ops/embedding.py:214-218,253-264"))

    for compute_dtype in (None, "bfloat16"):
        print(json.dumps({"dcnv2_training": train_dcnv2(
            device, compute_dtype, profile=profile)}), flush=True)
    print(json.dumps({"run_expid": run_expids(
        os.path.dirname(os.path.abspath(__file__)))}), flush=True)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

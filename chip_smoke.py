#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fuxictr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``fuxictr_tpu_torch/ops/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes SIM gives it, and time kernel, plain version and the one PyTorch
   call that computes the same function (a yardstick only);
4. serve SIM at the repo's full width (embedding 32, attention 64, MLP
   [512, 256], short window 100, top-k 100, max_len 1000, batch 1024) on
   seeded synthetic side tables through ``LongCTRDataLoader``,
   ``RankModel.predict`` and ``RankModel.evaluate``; check that every
   kernel was launched on that path, and that the outputs agree with a run
   whose attention takes the plain version.

Prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a GPU or outside a checkout. ``--profile`` adds a
``torch.profiler`` breakdown of one SIM forward by kernel.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from collections import OrderedDict

import numpy as np
import torch

TOL = 1e-5                       # abs and rel, f32 kernel vs plain version
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20       # > 50 MB L2: every timed launch starts cold

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
    L2 flush, from CUDA events around the launch alone."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def k1_inputs(N, L, D, fully_masked, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(N, D, device="cuda", generator=g)
    k = torch.randn(N, L, D, device="cuda", generator=g)
    v = torch.randn(N, L, D, device="cuda", generator=g)
    mask = (torch.rand(N, L, device="cuda", generator=g) > 0.3).float()
    if fully_masked:
        mask[::4] = 0.0
    return q, k, v, mask


def k1_bound(N, L, D):
    bytes_moved = 4 * (2 * N * D + 2 * N * L * D + N * L)
    flops = 4 * N * L * D
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_target_attention():
    """K1 against its plain version at every shape; returns per-shape rows
    and the max abs error."""
    from fuxictr_tpu_torch.ops.target_attention import (
        target_attention_cuda, target_attention_reference)
    rows, worst = [], 0.0
    for N, L, D, fully_masked in K1_SHAPES:
        q, k, v, mask = k1_inputs(N, L, D, fully_masked)
        scale = D ** 0.5
        out = target_attention_cuda(q, k, v, mask, scale)
        ref = target_attention_reference(q, k, v, mask, scale)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=TOL, atol=TOL):
            raise AssertionError(
                f"target_attention N={N} L={L} D={D}: max abs err {err} "
                f"exceeds {TOL} abs / {TOL} rel")
        worst = max(worst, err)
        q4, k4, v4 = q[:, None, None, :], k[:, None], v[:, None]
        m4 = (mask > 0)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bound, bound_by = k1_bound(N, L, D)
        rows.append(OrderedDict(
            N=N, L=L, D=D, fully_masked_rows=fully_masked, max_abs_err=err,
            ms=time_ms(lambda: target_attention_cuda(q, k, v, mask, scale)),
            plain_ms=time_ms(
                lambda: target_attention_reference(q, k, v, mask, scale)),
            library_ms=time_ms(
                lambda: sdpa(q4, k4, v4, attn_mask=m4, scale=1.0 / scale)),
            bound_ms=bound, bound_by=bound_by))
        print(json.dumps({"target_attention": rows[-1]}), flush=True)
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


@contextlib.contextmanager
def plain_attention(model):
    """``model`` with every target attention forced to the plain version."""
    from fuxictr_tpu_torch.ops.attention import MultiHeadTargetAttention
    from fuxictr_tpu_torch.ops.target_attention import \
        target_attention_reference
    mods = [m for m in model.modules()
            if isinstance(m, MultiHeadTargetAttention)]
    saved = [m.attention_fn for m in mods]
    for m in mods:
        m.attention_fn = target_attention_reference
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.attention_fn = fn


def serve_sim(device, shape, seed=2019, profile=False):
    """SIM predict + evaluate on ``device``; returns the report and the
    main path's launch counts."""
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
        device=device, seed=seed)
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
    if diff > TOL or not np.array_equal(y, y_again):
        raise AssertionError(
            f"SIM y_pred with the kernel differs from the plain attention "
            f"by {diff} (limit {TOL}), or between two runs")

    report = OrderedDict(
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
        with torch.no_grad():
            report["forward_ms_per_batch"] = time_ms(
                lambda: [model(b) for b in placed], reps=5,
                warmup=1) / len(placed)
            with plain_attention(model):
                report["plain_attention_forward_ms_per_batch"] = time_ms(
                    lambda: [model(b) for b in placed], reps=5,
                    warmup=1) / len(placed)
            if profile:
                report["profile"] = profile_forward(model, placed[0])
    return report, launches


def profile_forward(model, batch, top=12):
    """Device time of one SIM forward by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(batch)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in events)
    events.sort(key=lambda e: -e.device_time_total)
    return {"device_ms": total / 1e3,
            "kernels": [[e.key[:80], e.device_time_total / 1e3, e.count]
                        for e in events[:top]]}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fuxictr_tpu_torch.ops import target_attention as ta
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    card = card_identity()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    so = ta.build()
    print(json.dumps({"build": {"kernels_ported": ["target_attention"],
                                "library": os.path.relpath(so),
                                "seconds": time.perf_counter() - t0}}))
    with open(so + ".log") as fd:
        ptxas = [ln.strip() for ln in fd if "registers" in ln
                 or "smem" in ln or "spill" in ln]
    print("ptxas: " + " | ".join(ptxas), flush=True)

    rows, worst = check_target_attention()
    report, launches = serve_sim(device, FULL, profile="--profile" in argv)
    print(json.dumps({"sim_serving": report}), flush=True)
    # two MultiHeadTargetAttention calls per forward, predict + evaluate
    expected = 2 * 2 * report["batches"]
    if launches["target_attention"] != expected:
        raise AssertionError(
            f"SIM serving launched target_attention "
            f"{launches['target_attention']} times, expected {expected}")

    main_row = next(r for r in rows if (r["N"], r["L"], r["D"]) == MAIN_SHAPE
                    and not r["fully_masked_rows"])
    kernels = [OrderedDict(
        name="target_attention", route="cuda",
        source="fuxictr_tpu_torch/ops/csrc/target_attention.cu",
        replaces="fuxictr_tpu/ops/pallas_kernels.py:109",
        launches=launches["target_attention"], max_abs_err=worst,
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

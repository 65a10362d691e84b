"""Tests of the PyTorch port that need an NVIDIA GPU (marked ``cuda``; they
skip where ``torch.cuda.is_available()`` is false). The file imports no JAX,
so that it runs on a machine without it, and without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fuxictr_tpu_torch.ops import embedding as emb
from fuxictr_tpu_torch.ops import target_attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, L, D, masked_rows, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((N, D), (N, L, D), (N, L, D))]
    mask = (rng.random((N, L)) > 0.3).astype(np.float32)
    mask[list(masked_rows)] = 0.0
    return arrays + [mask]


def _on_card(arrays, device, dtype):
    q, k, v, mask = (torch.from_numpy(a).to(device) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


def _check_kernel(q, k, v, mask):
    """The kernel against the plain version. f32: 1e-5 abs and rel, sums in
    another order. bf16: against the plain version computed in f32 from the
    same bf16 inputs, within one bf16 rounding of the output (relative
    2**-8) plus 1e-5 abs for the f32 sums: the kernel sums in f32 and
    rounds once."""
    D = q.shape[1]
    before = ta.target_attention_cuda.launches
    out = ta.target_attention_cuda(q, k, v, mask, D ** 0.5)
    torch.cuda.synchronize()
    assert ta.target_attention_cuda.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = ta.target_attention_reference(q.float(), k.float(), v.float(),
                                        mask, D ** 0.5)
    if q.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,L,D,masked_rows", [
    (1024, 99, 64, ()), (1024, 100, 64, (5,)), (300, 333, 24, (0, 7)),
    (7, 1, 8, (3,)),
    (64, 2048, 64, (9,)),        # several tiles per row: online rescale
    (33, 7, 6, (2,)),            # L*D*itemsize not a multiple of 16 bytes
    (9, 5, 5, ()),               # odd D: 2-byte rows in bf16
])
def test_kernel_matches_plain(cuda, dtype, N, L, D, masked_rows):
    _check_kernel(*_on_card(_inputs(N, L, D, masked_rows), cuda, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_unaligned_tensors(cuda, dtype):
    """Contiguous views one element into their storage: not 16-byte
    aligned, so the kernel loads without bulk copies."""
    q, k, v, mask = _on_card(_inputs(40, 30, 16, (1,)), cuda, dtype)
    q, k, v = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
               .view(t.shape) for t in (q, k, v))
    assert k.data_ptr() % 16 != 0
    _check_kernel(q, k, v, mask)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(4, 10, 300, ()))
    with pytest.raises(ValueError, match="head dim"):
        ta.target_attention_cuda(q, k, v, mask, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ta.target_attention_cuda(q[:, :8], k[..., :8], v[..., :8], mask, 1.0)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_sim_on_the_card_matches_the_cpu(cuda, compute_dtype):
    """The same seeded SIM on both devices, at a small width, over a few
    batches, with two kernel launches per batch. f32: per-row y_pred within
    1e-5 (f32 products in another order). bf16: within 2e-3, a logit
    moved by about two bf16 steps near 1 (the sigmoid's slope is at most
    1/4): the card's kernel rounds its output once where the CPU's plain
    version rounds after each step, and the bf16 GEMMs of the two devices
    may round the last bit differently."""
    import chip_smoke
    from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader
    from fuxictr_tpu_torch.models import get_model
    shape = dict(n_users=200, n_items=500, n_cates=20, min_len=5,
                 max_len=60, batch=64, full_batches=2, tail=9)
    data, user_seqs, items = chip_smoke.make_side_tables(shape, seed=3)
    fm = chip_smoke.sim_feature_map(shape)
    loader = LongCTRDataLoader(fm, data, batch_size=64, user_info=user_seqs,
                               item_info=items, max_len=60)
    kw = dict(embedding_dim=16, attention_dim=16, num_heads=2,
              dnn_hidden_units=[32], short_seq_len=10, topk=8, seed=5,
              compute_dtype=compute_dtype)
    models = [get_model("SIM")(fm, device=d, **kw) for d in ("cpu", cuda)]
    g = torch.Generator().manual_seed(1)
    tables = {n: torch.randn(p.shape, generator=g) * 0.5
              for n, p in models[0].embedding.named_parameters()}
    for m in models:
        with torch.no_grad():
            for n, p in m.embedding.named_parameters():
                p.copy_(tables[n])
    before = ta.target_attention_cuda.launches
    y_cpu, y_gpu = (m.predict(loader) for m in models)
    assert ta.target_attention_cuda.launches == before + 2 * len(loader)
    tol = 1e-5 if compute_dtype is None else 2e-3
    np.testing.assert_allclose(y_gpu, y_cpu, rtol=0, atol=tol)


def _check_backward(q, k, v, mask, seed=1):
    """The backward kernel against the plain gradient computed in f32 from
    the same inputs (q, k, v, mask, the forward's out and dout), rounded
    once to their type, within the forward's tolerances: f32 1e-5 abs and
    rel; bf16 one rounding (2**-8 relative) plus 1e-5 abs. Returns the
    kernel's (dq, dk, dv, dout)."""
    D = q.shape[1]
    scale = D ** 0.5
    g = torch.Generator(device=q.device).manual_seed(seed)
    dout = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    out, stats = ta.target_attention_cuda(q, k, v, mask, scale,
                                          with_stats=True)
    before = ta.target_attention_bwd_cuda.launches
    grads = ta.target_attention_bwd_cuda(q, k, v, mask, out, dout, stats,
                                         scale)
    torch.cuda.synchronize()
    assert ta.target_attention_bwd_cuda.launches == before + 1
    ref = ta.target_attention_backward_reference(
        q.float(), k.float(), v.float(), mask, scale, dout.float(),
        out=out.float())
    rtol = 1e-5 if q.dtype == torch.float32 else 2 ** -8
    for got, want in zip(grads, ref):
        assert got.dtype == q.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)
    return (*grads, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,L,D,masked_rows", [
    # chip_smoke.K1_SHAPES
    (1024, 99, 64, ()), (1024, 100, 64, ()), (2048, 2048, 64, ()),
    (1024, 100, 64, tuple(range(0, 1024, 4))), (517, 333, 24, (0, 7)),
    # and more
    (1024, 100, 64, (5,)), (300, 333, 24, (0, 7)), (7, 1, 8, (3,)),
    (64, 2048, 64, (9,)),        # a long row: several forward tiles
    (33, 7, 6, (2,)), (9, 5, 5, ()),
] + [
    # every lane-group form: D = 8 ... 256 takes 1 to 32 lanes a position
    # in bf16, and in f32 2 to 32 lanes of one 16-byte chunk or 32 lanes of
    # two (D = 256); D = 24 leaves idle lanes in each group (3 chunks on 4
    # lanes in bf16, 6 on 8 in f32); rows of 1, 7 and 100 positions
    (37, L, D, (2,)) for D in (8, 24, 32, 64, 128, 256) for L in (1, 7, 100)
])
def test_backward_kernel_matches_plain(cuda, dtype, N, L, D, masked_rows):
    _check_backward(*_on_card(_inputs(N, L, D, masked_rows), cuda, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_is_bitwise_repeatable(cuda, dtype):
    """No atomics: dq is summed in one fixed order, so two launches on the
    same inputs give the same bits."""
    q, k, v, mask = _on_card(_inputs(1024, 100, 64, (5,)), cuda, dtype)
    scale = 8.0
    dout = torch.randn(q.shape, device=cuda).to(dtype)
    out, stats = ta.target_attention_cuda(q, k, v, mask, scale,
                                          with_stats=True)
    first = ta.target_attention_bwd_cuda(q, k, v, mask, out, dout, stats,
                                         scale)
    second = ta.target_attention_bwd_cuda(q, k, v, mask, out, dout, stats,
                                          scale)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_on_fully_masked_rows(cuda, dtype):
    """p is 1/L on a fully masked row: dv = dout / L everywhere, dq and dk
    are 0, as jax.vjp gives."""
    q, k, v, mask = _on_card(_inputs(16, 40, 32, (3, 11)), cuda, dtype)
    dq, dk, dv, dout = _check_backward(q, k, v, mask)
    for r in (3, 11):
        assert not dq[r].any() and not dk[r].any()
        torch.testing.assert_close(
            dv[r].float(), (dout[r].float() / 40).expand(40, -1),
            rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_takes_unaligned_tensors(cuda, dtype):
    q, k, v, mask = _on_card(_inputs(40, 30, 16, (1,)), cuda, dtype)
    q, k, v = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
               .view(t.shape) for t in (q, k, v))
    assert k.data_ptr() % 16 != 0
    _check_backward(q, k, v, mask)


def _expand_case(N, U, V, k, used, pad_share, seed=0):
    """An expand's backward inputs as SIM's loader makes them: ``used`` of
    the U slots are real (the rest bucket padding, id 0, no position), slot
    0 takes ``pad_share`` of the positions (the history padding item), ids
    of k fields drawn from V rows (so fields and slots share rows)."""
    rng = np.random.default_rng(seed)
    inv = rng.integers(1, used, N)
    inv[rng.random(N) < pad_share] = 0
    ids = np.zeros((k, U), np.int64)
    ids[:, :used] = rng.integers(0, V, (k, used))
    mask = np.zeros((k, U), bool)
    mask[:, :used] = rng.random((k, used)) > 0.1
    return inv, ids, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,U,V,k,used,pad_share,D", [
    (1_025_024, 32768, 90002, 1, 30001, 0.35, 32),   # SIM's item_id field
    (20_000, 4096, 300, 2, 3000, 0.2, 8),            # two fields share rows
    (5_000, 8192, 5000, 1, 700, 0.0, 16),           # bucket padding
    (300, 4096, 50, 3, 40, 0.5, 40),                # D > 32, k * D > 32
])
def test_expand_backward_kernel_matches_plain(cuda, dtype, N, U, V, k, used,
                                              pad_share, D):
    """Against the plain backward computed in f64 from the same g (in f32
    its index_add_ adds with atomics, in another order on each run, and is
    itself off by about the tolerance at a third of a million rows). f32:
    1e-5 relative, plus 1e-5 of the largest row sum absolute (the kernel's
    f32 sums of up to a third of a million rows); bf16: one rounding
    (2**-8 relative) on top. Two launches give the same bits."""
    inv, ids, mask = _expand_case(N, U, V, k, used, pad_share)
    g = torch.Generator(device=cuda).manual_seed(2)
    grad = torch.randn(N, k * D, generator=g, device=cuda).to(dtype)
    inv, ids = (torch.from_numpy(a).to(cuda) for a in (inv, ids))
    mask = torch.from_numpy(mask).to(cuda) if k > 1 else None
    before = emb.table_gather_expand_bwd_cuda.launches
    out = emb.table_gather_expand_bwd_cuda(grad, inv, ids, mask, V)
    again = emb.table_gather_expand_bwd_cuda(grad, inv, ids, mask, V)
    torch.cuda.synchronize()
    assert emb.table_gather_expand_bwd_cuda.launches == before + 2
    assert out.dtype == dtype and out.shape == (V, D)
    assert torch.equal(out, again)
    ref = emb.table_gather_expand_bwd_reference(grad.double(), inv, ids,
                                                mask, V)
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(out.double(), ref, rtol=rtol,
                               atol=1e-5 * float(ref.abs().max()))


def test_expand_backward_refuses_what_it_does_not_take(cuda):
    g = torch.zeros(10, 8, device=cuda)
    inv = torch.zeros(10, dtype=torch.int64, device=cuda)
    ids = torch.zeros(1, 4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        emb.table_gather_expand_bwd_cuda(g.double(), inv, ids, None, 5)
    with pytest.raises(TypeError):
        emb.table_gather_expand_bwd_cuda(g, inv.int(), ids, None, 5)
    with pytest.raises(ValueError, match="columns"):
        emb.table_gather_expand_bwd_cuda(g, inv, ids.expand(3, 4), None, 5)
    with pytest.raises(ValueError, match="CUDA"):
        emb.table_gather_expand_bwd_cuda(g.cpu(), inv, ids, None, 5)


def _small_sim(device, compute_dtype, seed=5):
    """A seeded SIM at a small width over a few batches of the smoke's
    synthetic tables, its tables spread (std 0.5) so that attention is not
    uniform; and its loader."""
    import chip_smoke
    from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader
    from fuxictr_tpu_torch.models import get_model
    shape = dict(n_users=200, n_items=500, n_cates=20, min_len=5,
                 max_len=60, batch=64, full_batches=2, tail=9)
    data, user_seqs, items = chip_smoke.make_side_tables(shape, seed=3)
    fm = chip_smoke.sim_feature_map(shape)
    loader = LongCTRDataLoader(fm, data, batch_size=64, user_info=user_seqs,
                               item_info=items, max_len=60)
    model = get_model("SIM")(fm, device=device, embedding_dim=16,
                             attention_dim=16, num_heads=2,
                             dnn_hidden_units=[32], short_seq_len=10,
                             topk=8, seed=seed, compute_dtype=compute_dtype,
                             table_size_buckets=(100,))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for table in model.embedding.parameters():
            table.copy_(torch.randn(table.shape, generator=g) * 0.5)
    return model, loader


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_sim_train_step_is_bitwise_repeatable(cuda, compute_dtype):
    """Two train steps from one state give the same bits (no atomics in
    the kernels' sums), and each step launches K1's forward and backward
    twice and K3's backward once per item field (buckets (100,) put
    item_id and cate_id in two tables)."""
    import chip_smoke
    model, loader = _small_sim(cuda, compute_dtype)
    batches = [model._place_batch(b) for b in loader]
    model.train_step(batches[0])                 # builds the optimizer
    snap = chip_smoke.snapshot(model)
    counts = (ta.target_attention_cuda.launches,
              ta.target_attention_bwd_cuda.launches,
              emb.table_gather_expand_bwd_cuda.launches)
    model.train_step(batches[1])
    first = [p.detach().clone() for p in model.parameters()]
    assert (ta.target_attention_cuda.launches - counts[0],
            ta.target_attention_bwd_cuda.launches - counts[1],
            emb.table_gather_expand_bwd_cuda.launches - counts[2]) \
        == (2, 2, 2)
    chip_smoke.restore(model, snap)
    model.train_step(batches[1])
    for a, b in zip(first, model.parameters()):
        assert torch.equal(a, b)


def test_sim_train_gradients_on_the_card_match_the_cpu(cuda):
    """The same seeded SIM on both devices, f32: the loss within 1e-5
    relative and every parameter's gradient within 1e-5 of its largest
    entry (sums in another order; the card's kernels against the CPU's
    plain versions)."""
    models = [_small_sim(d, None)[0] for d in ("cpu", cuda)]
    loader = _small_sim("cpu", None)[1]
    batch = next(iter(loader))
    (loss_c, grads_c), (loss_g, grads_g) = (m.loss_and_grads(batch)
                                            for m in models)
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for gc, gg in zip(grads_c, grads_g):
        torch.testing.assert_close(gg.cpu(), gc, rtol=0,
                                   atol=1e-5 * float(gc.abs().max()) + 1e-9)


def _small_dcnv2(device, compute_dtype=None, seed=5):
    """A seeded DCNv2 of bench.py's form at a small width (6 categorical
    fields of vocab 300, 4 numeric, dim 8, two cross layers, towers [64,
    32]) and its synthetic batches."""
    from fuxictr_tpu_torch.models import get_model
    from fuxictr_tpu_torch.utils.synthetic import (make_synthetic_batch,
                                                   make_synthetic_feature_map)
    fm = make_synthetic_feature_map(num_categorical=6, num_numeric=4,
                                    vocab_size=300, embedding_dim=8)
    model = get_model("DCNv2")(fm, device=device, embedding_dim=8,
                               num_cross_layers=2,
                               parallel_dnn_hidden_units=[64, 32],
                               compute_dtype=compute_dtype, seed=seed)
    return model, [make_synthetic_batch(fm, 512, seed=s) for s in range(2)]


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_dcnv2_train_step_is_bitwise_repeatable(cuda, compute_dtype):
    """Two train steps from one state give the same bits, loss included
    (the table gradient's ``index_put_`` adds duplicate ids in a fixed
    order), and launch no K1 or K3 kernel."""
    import chip_smoke
    model, batches = _small_dcnv2(cuda, compute_dtype)
    placed = [model._place_batch(b) for b in batches]
    model.train_step(placed[0])                  # builds the optimizer
    snap = chip_smoke.snapshot(model)
    counts = (ta.target_attention_cuda.launches,
              ta.target_attention_bwd_cuda.launches,
              emb.table_gather_expand_bwd_cuda.launches)
    loss = model.train_step(placed[1])
    first = [p.detach().clone() for p in model.parameters()]
    assert counts == (ta.target_attention_cuda.launches,
                      ta.target_attention_bwd_cuda.launches,
                      emb.table_gather_expand_bwd_cuda.launches)
    chip_smoke.restore(model, snap)
    assert torch.equal(model.train_step(placed[1]), loss)
    for a, b in zip(first, model.parameters()):
        assert torch.equal(a, b)


def test_dcnv2_train_gradients_on_the_card_match_the_cpu(cuda):
    """The same seeded DCNv2 on both devices, f32, one batch: the loss
    within 1e-5 relative and every parameter's gradient within 1e-5 of its
    largest entry (sums in another order). A ReLU input within f32
    rounding of zero may take another side on the other device and move
    one example's term of a weight gradient, so the CPU step takes the
    card's side of each tower ReLU, as ``chip_smoke.py`` does."""
    import chip_smoke
    (cpu_model, batches), (card_model, _) = (_small_dcnv2(d)
                                             for d in ("cpu", cuda))
    kept, _, hooks = chip_smoke._tower_hooks(card_model)
    loss_g, grads_g = card_model.loss_and_grads(batches[0])
    _, _, cpu_hooks = chip_smoke._tower_hooks(cpu_model, pin=kept)
    loss_c, grads_c = cpu_model.loss_and_grads(batches[0])
    for h in hooks + cpu_hooks:
        h.remove()
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for gc, gg in zip(grads_c, grads_g):
        torch.testing.assert_close(gg.cpu(), gc, rtol=0,
                                   atol=1e-5 * float(gc.abs().max()) + 1e-9)

"""Tests of the PyTorch port that need an NVIDIA GPU (marked ``cuda``; they
skip where ``torch.cuda.is_available()`` is false). The file imports no JAX,
so that it runs on a machine without it, and without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fuxictr_tpu_torch.ops import target_attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
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

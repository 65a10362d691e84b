"""The port's single-query target attention
(``fuxictr_tpu_torch/ops/target_attention.py``) against the JAX package:
its XLA path ``_xla_target_attention`` and its Pallas kernel
``flash_target_attention`` run in interpret mode. Inputs come from a numpy
seed. Tolerance: 2e-5 abs and rel in float32, f32 sums taken in another
order; each bfloat16 case states its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuxictr_tpu.ops.pallas_kernels import (_xla_target_attention,
                                            flash_target_attention)
from fuxictr_tpu_torch.ops import target_attention as ta

TOL = 2e-5
# bf16 against _xla_target_attention on the same bf16 inputs: the same ops
# in the same type and order, so at most one bf16 step (2**-7 relative)
# where a sum taken in another order rounds the other way
TOL_BF16_XLA = 2 ** -7
# bf16 against the Pallas kernel: its body sums in f32 and rounds once, the
# plain version rounds after each step, so up to two bf16 steps on outputs
# below 1
TOL_BF16_PALLAS = 2 ** -6


def _inputs(B, L, D, masked_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    k = rng.normal(size=(B, L, D)).astype(np.float32)
    v = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[list(masked_rows)] = 0.0
    return q, k, v, mask


def _port(q, k, v, mask, scale, dtype="float32"):
    """The port on CPU tensors: q, k, v in ``dtype``, mask float32; the
    result as float32 numpy."""
    dtype = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    out = ta.target_attention(q, k, v, torch.from_numpy(mask), scale)
    assert out.dtype == dtype
    return out.float().numpy()


_XLA_CASES = [
    ((8, 64, 16, (), None), "8-64-16-masked_rows0-None"),  # test_pallas shapes
    ((5, 100, 24, (), None), "5-100-24-masked_rows1-None"),
    ((6, 40, 16, (0, 3), None), "6-40-16-masked_rows2-None"),  # masked rows
    ((4, 50, 8, (), 1.0), "4-50-8-masked_rows3-1.0"),      # use_scale=False
]


@pytest.mark.parametrize("B,L,D,masked_rows,scale,dtype", [
    pytest.param(*case, dtype, id=name + suffix)
    for dtype, suffix in (("float32", ""), ("bfloat16", "-bfloat16"))
    for case, name in _XLA_CASES])
def test_plain_matches_xla(B, L, D, masked_rows, scale, dtype):
    q, k, v, mask = _inputs(B, L, D, masked_rows)
    scale = float(np.sqrt(D)) if scale is None else scale
    q, k, v = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    ref = _xla_target_attention(q, k, v, jnp.asarray(mask), scale)
    out = _port(*(np.array(a.astype(jnp.float32)) for a in (q, k, v)),
                mask, scale, dtype)
    tol = TOL if dtype == "float32" else TOL_BF16_XLA
    assert ref.dtype == dtype
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# Only rows with a valid position: on a fully masked row the Pallas kernel
# divides by its padded L (the port and the XLA path average over the real
# L), and the kernel always scales by sqrt(D), so scale=1.0 has no
# counterpart there.
@pytest.mark.parametrize("B,L,D,dtype", [
    pytest.param(8, 64, 16, "float32", id="8-64-16"),
    pytest.param(5, 100, 24, "float32", id="5-100-24"),
    pytest.param(8, 64, 16, "bfloat16", id="8-64-16-bfloat16"),
    pytest.param(5, 100, 24, "bfloat16", id="5-100-24-bfloat16")])
def test_plain_matches_pallas_interpret(B, L, D, dtype):
    q, k, v, mask = _inputs(B, L, D)
    q, k, v = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    ref = flash_target_attention(q, k, v, jnp.asarray(mask),
                                 block_b=8, block_l=32, interpret=True)
    out = _port(*(np.array(a.astype(jnp.float32)) for a in (q, k, v)),
                mask, float(np.sqrt(D)), dtype)
    tol = TOL if dtype == "float32" else TOL_BF16_PALLAS
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_fully_masked_row_is_mean_of_v():
    q, k, v, mask = _inputs(3, 20, 8, masked_rows=(1,))
    out = _port(q, k, v, mask, float(np.sqrt(8)))
    np.testing.assert_allclose(out[1], v[1].mean(0), rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the CUDA wrapper was called for CPU tensors")

    monkeypatch.setattr(ta, "target_attention_cuda", no_kernel)
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(4, 30, 8))
    out = ta.target_attention(q, k, v, mask, 2.0)
    torch.testing.assert_close(
        out, ta.target_attention_reference(q, k, v, mask, 2.0),
        rtol=0, atol=0)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach the CUDA branch
    of the dispatch without a GPU."""

    @property
    def is_cuda(self):
        return True


def test_cuda_path_refuses_inputs_that_require_grad(monkeypatch):
    """On the CUDA branch, inputs that require grad are refused to the
    plain version: they go through ``TargetAttentionFunction`` to the
    kernel's training forward (``with_stats``) and its backward wrapper,
    and the gradients are what those return. (The kernels are stood in for
    by their plain versions; the name dates from before the backward
    kernel, when this path raised.)"""
    calls = []
    reference = ta.target_attention_reference

    def forward(q, k, v, mask, scale, with_stats=False):
        calls.append(("forward", with_stats))
        out = reference(q, k, v, mask, scale)
        return out, torch.zeros(q.shape[0], 2)

    def backward(q, k, v, mask, out, dout, stats, scale):
        calls.append(("backward", tuple(stats.shape)))
        return ta.target_attention_backward_reference(q, k, v, mask, scale,
                                                      dout)

    def plain(*args):
        raise AssertionError("the plain version ran for CUDA inputs")

    monkeypatch.setattr(ta, "target_attention_cuda", forward)
    monkeypatch.setattr(ta, "target_attention_bwd_cuda", backward)
    monkeypatch.setattr(ta, "target_attention_reference", plain)
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 10, 8))
    q, k = (t.requires_grad_() for t in (q, k))
    out = ta.target_attention(q.as_subclass(_CudaLike), k, v, mask, 1.0)
    dq, dk = torch.autograd.grad(out.sum(), (q, k))
    assert calls == [("forward", True), ("backward", (2, 2))]
    monkeypatch.undo()
    ref_dq, ref_dk, _ = ta.target_attention_backward_reference(
        q.detach(), k.detach(), v, mask, 1.0, torch.ones(2, 8))
    torch.testing.assert_close(dq.as_subclass(torch.Tensor), ref_dq)
    torch.testing.assert_close(dk.as_subclass(torch.Tensor), ref_dk)


def test_cuda_path_launches_the_kernel_wrapper(monkeypatch):
    calls = []
    monkeypatch.setattr(ta, "target_attention_cuda",
                        lambda *args: calls.append(args) or "kernel")
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 10, 8))
    with torch.no_grad():
        out = ta.target_attention(q.as_subclass(_CudaLike), k, v, mask, 1.0)
    assert out == "kernel" and len(calls) == 1


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 10, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ta.target_attention_cuda(q, k, v, mask, 1.0)


def test_kernel_wrapper_requires_a_mask():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 10, 8))
    with pytest.raises(ValueError, match="mask"):
        ta.target_attention_cuda(q, k, v, None, 1.0)


@pytest.mark.parametrize("q_dtype,kv_dtype,mask_dtype", [
    (torch.float32, torch.bfloat16, torch.float32),     # mixed q and k/v
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float16, torch.float16, torch.float32),      # no fp16 entry point
    (torch.float64, torch.float64, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),   # the mask is f32
    (torch.float32, torch.float32, torch.float64),
])
def test_kernel_wrapper_refuses_mixed_or_unsupported_types(
        q_dtype, kv_dtype, mask_dtype):
    """Checked before the device: the wrapper converts no type."""
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 10, 8))
    with pytest.raises(TypeError):
        ta.target_attention_cuda(q.to(q_dtype), k.to(kv_dtype),
                                 v.to(kv_dtype), mask.to(mask_dtype), 1.0)

"""The port's single-query target attention
(``fuxictr_tpu_torch/ops/target_attention.py``) against the JAX package:
its XLA path ``_xla_target_attention`` and its Pallas kernel
``flash_target_attention`` run in interpret mode. Inputs come from a numpy
seed. Tolerance: 2e-5 abs and rel, f32 sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuxictr_tpu.ops.pallas_kernels import (_xla_target_attention,
                                            flash_target_attention)
from fuxictr_tpu_torch.ops import target_attention as ta

TOL = 2e-5


def _inputs(B, L, D, masked_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    k = rng.normal(size=(B, L, D)).astype(np.float32)
    v = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[list(masked_rows)] = 0.0
    return q, k, v, mask


def _port(q, k, v, mask, scale):
    return ta.target_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                               scale).numpy()


@pytest.mark.parametrize("B,L,D,masked_rows,scale", [
    (8, 64, 16, (), None),           # tests/test_pallas_kernels.py shapes
    (5, 100, 24, (), None),
    (6, 40, 16, (0, 3), None),       # fully masked rows
    (4, 50, 8, (), 1.0),             # use_scale=False
])
def test_plain_matches_xla(B, L, D, masked_rows, scale):
    q, k, v, mask = _inputs(B, L, D, masked_rows)
    scale = float(np.sqrt(D)) if scale is None else scale
    ref = _xla_target_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask), scale)
    np.testing.assert_allclose(_port(q, k, v, mask, scale), np.asarray(ref),
                               rtol=TOL, atol=TOL)


# Only rows with a valid position: on a fully masked row the Pallas kernel
# divides by its padded L (the port and the XLA path average over the real
# L), and the kernel always scales by sqrt(D), so scale=1.0 has no
# counterpart there.
@pytest.mark.parametrize("B,L,D", [(8, 64, 16), (5, 100, 24)])
def test_plain_matches_pallas_interpret(B, L, D):
    q, k, v, mask = _inputs(B, L, D)
    ref = flash_target_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask),
                                 block_b=8, block_l=32, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, mask, float(np.sqrt(D))),
                               np.asarray(ref), rtol=TOL, atol=TOL)


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


def test_cuda_path_refuses_inputs_that_require_grad():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 10, 8))
    q = q.requires_grad_().as_subclass(_CudaLike)
    with pytest.raises(NotImplementedError, match="no backward"):
        ta.target_attention(q, k, v, mask, 1.0)


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

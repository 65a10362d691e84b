"""Single-query target attention: the port of the Pallas TPU kernel
``fuxictr_tpu/ops/pallas_kernels.py:flash_target_attention``, with a
gradient.

For each row n: ``softmax_l(q[n]·k[n, l] / scale) @ v[n]``, with masked
positions (``mask <= 0``) scored -1e9 before the softmax. A row whose mask
is all zero returns the mean of v over L, as ``_xla_target_attention`` and
the JAX model do.

- :func:`target_attention_cuda` launches the hand-written CUDA kernel
  (``csrc/target_attention.cu``), built with nvcc for ``sm_90a`` on first
  use into ``fuxictr_tpu_torch/_build/`` and loaded through ctypes. It takes
  float32 or bfloat16 q, k, v (one type for all three) and a float32 mask,
  sums in float32, and returns q's type; with ``with_stats`` it launches
  the training entry point, which also returns each row's softmax max and
  denominator.
- :func:`target_attention_bwd_cuda` launches the backward kernel (same
  source) on those statistics: dq, dk, dv.
- :func:`target_attention_reference` is the plain PyTorch version, line for
  line the JAX package's ``_xla_target_attention``, in the inputs' type;
  :func:`target_attention_backward_reference` is its gradient as JAX's
  autodiff computes it.
- :class:`TargetAttentionFunction` is the autograd Function: kernels on
  CUDA tensors, plain versions on CPU tensors. :func:`target_attention`
  takes it when an input requires grad, else the forward alone.
"""

import ctypes
import functools

import torch

from fuxictr_tpu_torch.ops import cuda_build

_NEG_INF = -1.0e9
_MAX_D = 256        # kThreads in the kernel: one thread per column at most


def target_attention_weights(q, k, mask, scale):
    """The softmax weights [N, L] of the plain version, in the type of q and
    k. The scale is rounded to that type first, as jnp casts a Python
    scalar. In bfloat16 the softmax is written out as ``jax.nn.softmax``
    is, so that it rounds after the same steps as there; float32 takes
    torch's softmax, the same function in one kernel."""
    scale = float(torch.tensor(scale, dtype=q.dtype))
    scores = torch.einsum("bd,bld->bl", q, k) / scale
    if mask is not None:
        scores = torch.where(mask > 0, scores, _NEG_INF)
    if q.dtype == torch.float32:
        return torch.softmax(scores, dim=-1)
    unnormalized = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return unnormalized / unnormalized.sum(dim=-1, keepdim=True)


def target_attention_reference(q, k, v, mask, scale):
    """Plain PyTorch: q [N, D], k/v [N, L, D], mask [N, L] or None, in the
    type of q, k, v; line for line ``_xla_target_attention``."""
    return torch.einsum("bl,bld->bd", target_attention_weights(q, k, mask,
                                                               scale), v)


def target_attention_backward_reference(q, k, v, mask, scale, dout,
                                        out=None):
    """Gradient of :func:`target_attention_reference` for ``dout`` [N, D]:
    ``(dq, dk, dv)`` in the inputs' type, as ``jax.vjp`` of
    ``_xla_target_attention`` computes it op by op. ``jax.nn.softmax`` is
    ``e / s`` with ``e = exp(x - max)`` and ``s`` summed in float32 and
    rounded, and JAX differentiates that expression, so the softmax's
    gradient is written as its autodiff: ``de = dattn / s - sum(dattn *
    s^-2 * e)``, ``dx = de * e``, each step rounded to the inputs' type as
    there; in bfloat16 the sum over L adds position by position, rounding
    each partial sum, as XLA's CPU ``reduce_sum`` does in that type over up
    to 32 positions (it adds longer rows in another order). The
    ``where`` on the mask zeroes the scores' gradient at masked positions,
    and the scale is rounded to the inputs' type as in the forward.

    Given the forward's ``out``, the softmax's gradient is taken in the
    form the backward kernel computes, ``attn * (dattn - dout·out)`` (the
    same number by the chain rule): what the kernel is held against."""
    scale_t = float(torch.tensor(scale, dtype=q.dtype))
    scores = torch.einsum("bd,bld->bl", q, k) / scale_t
    if mask is not None:
        scores = torch.where(mask > 0, scores, _NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    s = e.sum(dim=-1, keepdim=True)
    attn = e / s
    dv = torch.einsum("bl,bd->bld", attn, dout)
    dattn = torch.einsum("bd,bld->bl", dout, v)
    if out is None:
        t = dattn * (1.0 / (s * s)) * e
        if q.dtype == torch.float32:
            total = t.sum(dim=-1, keepdim=True)
        else:
            total = t[:, :1]
            for pos in range(1, t.shape[1]):
                total = total + t[:, pos:pos + 1]
        dscores = (dattn / s - total) * e
    else:
        dscores = attn * (dattn - (dout * out).sum(dim=-1, keepdim=True))
    if mask is not None:
        dscores = torch.where(mask > 0, dscores, 0.0)
    dscores = dscores / scale_t
    return (torch.einsum("bl,bld->bd", dscores, k),
            torch.einsum("bl,bd->bld", dscores, q), dv)


def build():
    """Compile ``csrc/target_attention.cu`` (see :mod:`cuda_build`) and
    return the path of the shared library."""
    return cuda_build.build("target_attention")


_DTYPE_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _library():
    lib = ctypes.CDLL(build())
    for tag in _DTYPE_TAGS.values():
        for name, args in (
                (f"target_attention_fwd_{tag}",
                 [_P] * 5 + [_I] * 3 + [_F, _P]),
                (f"target_attention_fwd_stats_{tag}",
                 [_P] * 6 + [_I] * 3 + [_F, _P]),
                (f"target_attention_bwd_{tag}",
                 [_P] * 10 + [_I] * 3 + [_F, _P])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.target_attention_error_string.argtypes = [ctypes.c_int]
    lib.target_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, q, k, v, mask, *rows):
    """The checks every entry point's launcher trusts: q, k, v (and the
    [N, D] ``rows``) of one type, float32 or bfloat16, a float32 mask, one
    CUDA device, agreeing shapes, D <= 256, contiguous. Returns N, L, D.
    Converts no type."""
    if mask is None:
        raise ValueError(f"{name} needs a mask [N, L]")
    if q.dtype not in _DTYPE_TAGS or any(t.dtype != q.dtype
                                         for t in (k, v) + rows):
        raise TypeError(f"{name} takes q, k, v all float32 or all bfloat16, "
                        f"not {q.dtype}, {k.dtype}, {v.dtype}")
    if mask.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 mask, not {mask.dtype}")
    tensors = (q, k, v, mask) + rows
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    N, L, D = k.shape
    if q.shape != (N, D) or v.shape != (N, L, D) \
            or any(t.shape != (N, D) for t in rows):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"head dim {D} is outside 1..{_MAX_D}")
    if mask.shape != (N, L):
        raise ValueError(f"mask {tuple(mask.shape)} is not [{N}, {L}]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return N, L, D


def _raise_on(lib, code, what):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.target_attention_error_string(code).decode())


def target_attention_cuda(q, k, v, mask, scale, with_stats=False):
    """Launch the CUDA kernel on the current stream. Contiguous q [N, D],
    k/v [N, L, D], all float32 or all bfloat16; mask [N, L] float32
    (required); D <= 256. Returns [N, D] in q's type; with ``with_stats``,
    also the [N, 2] float32 (max, denominator) of each row's softmax, which
    :func:`target_attention_bwd_cuda` takes. Raises on anything else; it
    converts no type. The launcher in the ``.cu`` trusts these checks."""
    N, L, D = _check("target_attention_cuda", q, k, v, mask)
    out = torch.empty_like(q)
    stats = (torch.empty(N, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    if N == 0 or L == 0:
        out.zero_()             # empty softmax: what the plain path returns
        if with_stats:          # max -1e9 and denominator 1: p = 0
            stats[:, 0], stats[:, 1] = _NEG_INF, 1.0
        return (out, stats) if with_stats else out
    lib = _library()
    tag = _DTYPE_TAGS[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if with_stats:
            code = getattr(lib, f"target_attention_fwd_stats_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), stats.data_ptr(), N, L, D, float(scale),
                stream)
        else:
            code = getattr(lib, f"target_attention_fwd_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), N, L, D, float(scale), stream)
    _raise_on(lib, code, "target_attention")
    target_attention_cuda.launches += 1
    return (out, stats) if with_stats else out


target_attention_cuda.launches = 0


def target_attention_bwd_cuda(q, k, v, mask, out, dout, stats, scale):
    """Launch the backward kernel on the current stream: the inputs of
    :func:`target_attention_cuda`, its output ``out`` and the incoming
    gradient ``dout`` (both [N, D], q's type), and the ``stats`` of its
    training entry point. Returns (dq, dk, dv) in q's type. Raises on
    anything else."""
    N, L, D = _check("target_attention_bwd_cuda", q, k, v, mask, out, dout)
    if stats is None or stats.dtype != torch.float32 \
            or stats.shape != (N, 2) or not stats.is_contiguous() \
            or stats.device != q.device:
        raise ValueError("target_attention_bwd_cuda needs the [N, 2] float32 "
                         "statistics of the training forward")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if N == 0 or L == 0:
        return dq.zero_(), dk, dv
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = getattr(lib, f"target_attention_bwd_{_DTYPE_TAGS[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), dout.data_ptr(), stats.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), N, L, D, float(scale), stream)
    _raise_on(lib, code, "target_attention backward")
    target_attention_bwd_cuda.launches += 1
    return dq, dk, dv


target_attention_bwd_cuda.launches = 0


class TargetAttentionFunction(torch.autograd.Function):
    """Target attention with its gradient. On CUDA tensors the forward
    launches K1's training entry point (which keeps each row's softmax
    statistics) and the backward launches K1's backward kernel; on CPU
    tensors both are the plain versions. The mask takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        if q.is_cuda:
            out, stats = target_attention_cuda(q, k, v, mask, scale,
                                               with_stats=True)
        else:
            out, stats = target_attention_reference(q, k, v, mask, scale), None
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, mask, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, stats = ctx.saved_tensors
        if q.is_cuda:
            grads = target_attention_bwd_cuda(q, k, v, mask, out,
                                              dout.contiguous(), stats,
                                              ctx.scale)
        else:
            grads = target_attention_backward_reference(q, k, v, mask,
                                                        ctx.scale, dout)
        return (*grads, None, None)


def target_attention(q, k, v, mask, scale):
    """Attention of one query per row: through
    :class:`TargetAttentionFunction` when an input requires grad, else the
    kernel on CUDA tensors and the plain version on CPU tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TargetAttentionFunction.apply(q, k, v, mask, scale)
    if not q.is_cuda:
        return target_attention_reference(q, k, v, mask, scale)
    return target_attention_cuda(q, k, v, mask, scale)

"""Single-query target attention: the port of the Pallas TPU kernel
``fuxictr_tpu/ops/pallas_kernels.py:flash_target_attention``.

For each row n: ``softmax_l(q[n]·k[n, l] / scale) @ v[n]``, with masked
positions (``mask <= 0``) scored -1e9 before the softmax. A row whose mask
is all zero returns the mean of v over L, as ``_xla_target_attention`` and
the JAX model do.

- :func:`target_attention_cuda` launches the hand-written CUDA kernel
  (``csrc/target_attention.cu``), built with nvcc for ``sm_90a`` on first
  use into ``fuxictr_tpu_torch/_build/`` and loaded through ctypes.
- :func:`target_attention_reference` is the plain PyTorch version, line for
  line the JAX package's ``_xla_target_attention``.
- :func:`target_attention` picks by device: CUDA tensors go to the kernel,
  CPU tensors to the plain version. The kernel has no backward yet, so on
  CUDA it refuses inputs that require grad; it also needs a mask.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_NEG_INF = -1.0e9
_MAX_D = 256        # kThreads in the kernel: one thread per column at most

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "target_attention.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_build_lock = threading.Lock()


def target_attention_reference(q, k, v, mask, scale):
    """Plain PyTorch: q [N, D], k/v [N, L, D], mask [N, L] or None."""
    scores = torch.einsum("bd,bld->bl", q, k) / scale
    if mask is not None:
        scores = torch.where(mask > 0, scores, _NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bl,bld->bd", attn, v)


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc"),
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the target-attention kernel")


def build():
    """Compile ``csrc/target_attention.cu`` unless a build of the same
    source and flags exists; return the path of the shared library. The
    compiler's messages (``-Xptxas -v``: registers, shared memory, spills)
    are kept beside it as ``.log``. Raises if nvcc fails."""
    with open(_SRC, "rb") as fd:
        src = fd.read()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(_BUILD_DIR, f"libtarget_attention_{tag[:16]}.so")
    with _build_lock:
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        with open(so + ".log", "w") as fd:
            fd.write(res.stdout + res.stderr)
        os.replace(tmp, so)
    return so


@functools.cache
def _library():
    lib = ctypes.CDLL(build())
    lib.target_attention_fwd_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    lib.target_attention_fwd_f32.restype = ctypes.c_int
    lib.target_attention_error_string.argtypes = [ctypes.c_int]
    lib.target_attention_error_string.restype = ctypes.c_char_p
    return lib


def target_attention_cuda(q, k, v, mask, scale):
    """Launch the CUDA kernel on the current stream. f32, contiguous:
    q [N, D], k/v [N, L, D], mask [N, L] (required), D <= 256. The launcher
    in the ``.cu`` trusts these checks."""
    if mask is None:
        raise ValueError("target_attention_cuda needs a mask [N, L]")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, mask)):
        raise ValueError("target_attention_cuda: all inputs must be on one "
                         "CUDA device")
    if not all(t.dtype == torch.float32 for t in (q, k, v)):
        raise TypeError("target_attention_cuda takes float32 q, k, v")
    N, L, D = k.shape
    if q.shape != (N, D) or v.shape != (N, L, D):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"head dim {D} is outside 1..{_MAX_D}")
    mask = mask.to(torch.float32)
    if mask.shape != (N, L):
        raise ValueError(f"mask {tuple(mask.shape)} is not [{N}, {L}]")
    if not all(t.is_contiguous() for t in (q, k, v, mask)):
        raise ValueError("target_attention_cuda takes contiguous tensors")
    out = torch.empty_like(q)
    if N == 0 or L == 0:
        return out.zero_()      # empty softmax: what the plain path returns
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.target_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), N, L, D, float(scale), stream)
    if code != 0:
        raise RuntimeError("target_attention kernel launch failed: "
                           + lib.target_attention_error_string(code).decode())
    target_attention_cuda.launches += 1
    return out


target_attention_cuda.launches = 0


def target_attention(q, k, v, mask, scale):
    """Attention of one query per row; the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not q.is_cuda:
        return target_attention_reference(q, k, v, mask, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the target-attention CUDA kernel has no backward yet; run it "
            "under torch.no_grad()")
    return target_attention_cuda(q, k, v, mask, scale)

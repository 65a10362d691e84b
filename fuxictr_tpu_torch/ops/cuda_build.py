"""Build the port's CUDA sources (``ops/csrc/<name>.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, under ``fuxictr_tpu_torch/_build/`` (gitignored),
named by a hash of the source and the flags, and loaded with ``ctypes`` by
the module that owns the kernel. Nothing here runs at import time.
"""

import collections
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_locks = collections.defaultdict(threading.Lock)    # one per source


def nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc"),
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def build(name):
    """Compile ``csrc/<name>.cu`` unless a build of the same source and
    flags exists; return the path of the shared library. The compiler's
    messages (``-Xptxas -v``: registers, shared memory, spills) are kept
    beside it as ``.log``. Raises if nvcc fails. Builds of different
    sources may run at once, from threads."""
    src_path = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src_path, "rb") as fd:
        src = fd.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(BUILD_DIR, f"lib{name}_{tag[:16]}.so")
    with _locks[name]:
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        with open(so + ".log", "w") as fd:
            fd.write(res.stdout + res.stderr)
        os.replace(tmp, so)
    return so

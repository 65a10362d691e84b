"""Rules of the PyTorch port: ``fuxictr_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX or of the JAX package, defer the optional host
libraries, and run on the GPU unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from fuxictr_tpu_torch import resolve_device
from fuxictr_tpu_torch.features import FeatureMap
from fuxictr_tpu_torch.models import get_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fuxictr_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fuxictr_tpu")
SLICE_MODULES = [
    "fuxictr_tpu_torch", "fuxictr_tpu_torch.config",
    "fuxictr_tpu_torch.features", "fuxictr_tpu_torch.metrics",
    "fuxictr_tpu_torch.data.longctr_loader",
    "fuxictr_tpu_torch.ops.common", "fuxictr_tpu_torch.ops.embedding",
    "fuxictr_tpu_torch.ops.mlp", "fuxictr_tpu_torch.ops.target_attention",
    "fuxictr_tpu_torch.ops.attention", "fuxictr_tpu_torch.models",
    "fuxictr_tpu_torch.models.zoo", "fuxictr_tpu_torch.utils.convert",
]


def _port_sources():
    for dirpath, dirs, files in os.walk(PACKAGE):
        dirs[:] = [d for d in dirs if d != "_build"]    # generated output
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            f"print(sorted(top & set({FORBIDDEN!r} + "
            "('yaml', 'pandas', 'sklearn'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_port_file_imports_jax(path):
    with open(path) as fd:
        tree = ast.parse(fd.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, device):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(device)


def test_sim_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    _no_cuda(monkeypatch)
    fm = FeatureMap("tiny_longctr")
    fm.load(os.path.join(ROOT, "data", "tiny_longctr", "feature_map.json"))
    kw = dict(embedding_dim=4, attention_dim=4, dnn_hidden_units=[8])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("SIM")(fm, **kw)
    assert get_model("SIM")(fm, device="cpu", **kw).device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

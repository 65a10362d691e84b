"""fuxictr_tpu_torch: the PyTorch/CUDA port of fuxictr_tpu for NVIDIA Hopper.

The package mirrors ``fuxictr_tpu``'s module layout so that each module has
an obvious counterpart, but imports nothing of it (nor JAX): the JAX package
is the reference the port is tested against. Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas is a CUDA kernel written by
hand for ``sm_90a`` (``ops/csrc``), built from source on first use.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None):
    """``torch.device`` for an entry point: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — the port never falls back to the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fuxictr_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return device

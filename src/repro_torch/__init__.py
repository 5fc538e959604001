"""PyTorch/CUDA port of the ``repro`` KAN acceleration package.

The layout mirrors ``src/repro`` (``core/``, ``kernels/``, ``hw/``,
``models/``, ``data/``, ``configs/``) so each module's counterpart has the
same name. This package imports ``torch`` and ``numpy`` only: never ``jax``
and nothing of ``repro``. The TPU Pallas kernels of the reference become
hand-written CUDA C++ kernels for Hopper (``kernels/csrc``), built with
``nvcc`` at first use.

Entry points take ``device=None``, which means the CUDA card; they raise if
there is none. Only an explicit ``device="cpu"`` runs on the CPU, where every
kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

# The reference contracts in full f32. TF32 keeps ~3 decimal digits, which
# would move the plain versions (lut/ref backends, kernel oracles) far from
# both the JAX package and the hand-written kernels.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card (raising if there is none); anything
    else is taken as given (``"cpu"`` runs the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

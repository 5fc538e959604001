"""Dense quantised KAN basis: the wrapper of the hand-written CUDA kernel
``csrc/kan_basis.cu``, which replaces no TPU kernel (the JAX package
computes the basis in ``jnp``).

The kernel turns bounded inputs into the crossbar backends' word-line
values in one pass: input code, PowerGap split, SH-LUT taps (reflected in
the upper half) and the dense ``[..., G+K]`` basis, bit for bit
``quant.quantized_basis``, which is its plain version; ``kernels.ops``
picks between the two by the device of the input.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import ASPConfig
from repro_torch.kernels import build
# the config's scalars, as kan_fused takes them
from repro_torch.kernels.kan_fused import _asp_args


def kan_basis(x: torch.Tensor, hemi: torch.Tensor, *, asp: ASPConfig
              ) -> torch.Tensor:
    """Launch the kernel: x [B, I] f32, hemi [ceil(L/2), K+1] f32, both
    contiguous on one CUDA device. Returns [B, I, G+K] f32. Counts each
    launch in ``kan_basis.launches``."""
    b, i = x.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("kan_basis: x must be on a CUDA device")
    for name, t in (("x", x), ("hemi", hemi)):
        if t.device != dev:
            raise ValueError(f"kan_basis: {name} must be on x's CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"kan_basis: {name} must be contiguous "
                             "torch.float32")
    s_, k1, ld, n_levels, half, x_min, step = _asp_args(asp)
    if hemi.shape != (half, k1):
        raise ValueError(f"kan_basis: SH-LUT {tuple(hemi.shape)} is not "
                         f"[ceil(L/2), K+1] = [{half}, {k1}]")
    lib = build.load()
    out = torch.empty((b, i, s_), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    build.check(lib.kan_basis_launch(
        x.data_ptr(), hemi.data_ptr(), out.data_ptr(), b * i, s_, k1, ld,
        n_levels, half, x_min, step, stream), "kan_basis launch")
    kan_basis.launches += 1
    return out


kan_basis.launches = 0

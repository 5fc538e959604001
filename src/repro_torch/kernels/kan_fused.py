"""Fused KAN spline layer: the wrapper of the hand-written CUDA kernel
``csrc/kan_fused.cu`` (port of the TPU kernel ``repro.kernels.kan_fused``).

The kernel fuses quantise -> PowerGap decode -> SH-LUT -> K+1-tap
contraction against int8 codes, so the expanded basis never reaches HBM.
Its plain version is ``kernels.ref.kan_spline_ref``; ``kernels.ops`` picks
between the two by the device of the input.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import ASPConfig
from repro_torch.kernels import build

MAX_TAPS = 4      # K + 1 held per (b, i) by the kernel
MAX_HALF = 128    # SH-LUT rows held in shared memory


def kan_fused(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
              hemi: torch.Tensor, *, asp: ASPConfig) -> torch.Tensor:
    """Launch the kernel: x [B, I] f32, codes [I, S, O] int8, scale [O] f32,
    hemi [ceil(L/2), K+1] f32, all contiguous on one CUDA device.
    Returns y [B, O] f32. Counts each launch in ``kan_fused.launches``."""
    b, i = x.shape
    o = codes.shape[-1]
    for name, t, dtype in (("x", x, torch.float32), ("codes", codes, torch.int8),
                           ("scale", scale, torch.float32),
                           ("hemi", hemi, torch.float32)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"kan_fused: {name} must be on x's CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kan_fused: {name} must be contiguous {dtype}")
    if codes.shape != (i, asp.n_basis, o) or scale.shape != (o,):
        raise ValueError(f"kan_fused: codes {tuple(codes.shape)} / scale "
                         f"{tuple(scale.shape)} do not fit x {tuple(x.shape)}")
    half, k1 = hemi.shape
    if k1 != asp.n_taps or not 1 <= k1 <= MAX_TAPS or half > MAX_HALF:
        raise ValueError(f"kan_fused: SH-LUT {tuple(hemi.shape)} outside the "
                         f"kernel's K+1 <= {MAX_TAPS}, rows <= {MAX_HALF}")
    lib = build.load()
    y = torch.empty((b, o), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.kan_fused_launch(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), hemi.data_ptr(),
        y.data_ptr(), b, i, asp.n_basis, o, k1, asp.ld, asp.n_levels, half,
        asp.x_min, asp.step, stream), "kan_fused launch")
    kan_fused.launches += 1
    return y


kan_fused.launches = 0

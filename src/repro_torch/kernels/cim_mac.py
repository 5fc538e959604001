"""Bit-sliced RRAM-ACIM MAC: the wrapper of the hand-written CUDA kernel
``csrc/cim_mac.cu`` (port of the TPU kernel ``repro.kernels.cim_mac``'s
``cim_mac``; the multi-tile ``cim_mac_tiled`` is not ported yet).

Every KAN layer's crossbar MAC is simulated bit slice by bit slice with
IR-drop row attenuation and an ADC readout at the end of each physical
array's row sum. Its plain version is ``kernels.ref.cim_mac_ref``;
``kernels.ops`` picks between the two by the device of the input.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def cim_mac(v: torch.Tensor, w_codes: torch.Tensor, row_atten: torch.Tensor,
            *, array_size: int, lsb: float) -> torch.Tensor:
    """Launch the kernel: v [B, R] f32, w_codes [R, C] int8, row_atten [R]
    f32, all contiguous on one CUDA device; ``lsb`` is the ADC step (rounded
    to f32 here, as the reference rounds its Python float). Returns [B, C]
    f32. Counts each launch in ``cim_mac.launches``."""
    b, r = v.shape
    c = w_codes.shape[-1]
    for name, t, dtype in (("v", v, torch.float32),
                           ("w_codes", w_codes, torch.int8),
                           ("row_atten", row_atten, torch.float32)):
        if t.device != v.device or t.device.type != "cuda":
            raise ValueError(f"cim_mac: {name} must be on v's CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"cim_mac: {name} must be contiguous {dtype}")
    if w_codes.shape != (r, c) or row_atten.shape != (r,) or array_size < 1:
        raise ValueError(f"cim_mac: w_codes {tuple(w_codes.shape)} / atten "
                         f"{tuple(row_atten.shape)} do not fit v "
                         f"{tuple(v.shape)}")
    lib = build.load()
    out = torch.empty((b, c), dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    build.check(lib.cim_mac_launch(
        v.data_ptr(), w_codes.data_ptr(), row_atten.data_ptr(),
        out.data_ptr(), b, r, c, array_size, lsb, stream), "cim_mac launch")
    cim_mac.launches += 1
    return out


cim_mac.launches = 0

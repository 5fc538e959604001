"""Bit-sliced RRAM-ACIM MACs: the wrappers of the hand-written CUDA kernels
``csrc/cim_mac.cu`` and ``csrc/cim_mac_tiled.cu``, two instantiations of
the body in ``csrc/cim_mac_common.cuh`` (port of the TPU kernels
``repro.kernels.cim_mac``'s ``cim_mac`` and ``cim_mac_tiled``).

Every KAN layer's crossbar MAC is simulated bit slice by bit slice with
IR-drop row attenuation and an ADC readout at the end of each physical
array's row sum. ``cim_mac`` models one monolithic array (f32 readouts);
``cim_mac_tiled`` a grid of tiles with a per-cell conductance gain, int32
readout codes and an integer reduction across row tiles. Their plain
versions are ``kernels.ref.cim_mac_ref`` and ``cim_mac_tiled_ref``;
``kernels.ops`` picks between kernel and plain version by the device of
the input.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build


def _check_inputs(what: str, device: torch.device, **tensors) -> None:
    """Every tensor contiguous, of its type, on v's CUDA device."""
    for name, (t, dtype) in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be on v's CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype}")


def cim_mac(v: torch.Tensor, w_codes: torch.Tensor, row_atten: torch.Tensor,
            *, array_size: int, lsb: float,
            rows_iterated: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel: v [B, R] f32, w_codes [R, C] int8, row_atten [R]
    f32, all contiguous on one CUDA device; a ragged last array counts as
    dead rows. ``lsb`` is the ADC step (rounded to f32 here, as the
    reference rounds its Python float). Returns [B, C] f32. If
    ``rows_iterated`` (an int64 [1] tensor on v's device) is given, the
    kernel adds to it the (batch row, row) pairs whose terms it formed, as
    ``cim_mac_tiled`` does. Counts each launch in ``cim_mac.launches``."""
    b, r = v.shape
    c = w_codes.shape[-1]
    tensors = dict(v=(v, torch.float32), w_codes=(w_codes, torch.int8),
                   row_atten=(row_atten, torch.float32))
    if rows_iterated is not None:
        tensors["rows_iterated"] = (rows_iterated, torch.int64)
    _check_inputs("cim_mac", v.device, **tensors)
    if (w_codes.shape != (r, c) or row_atten.shape != (r,) or array_size < 1
            or (rows_iterated is not None and rows_iterated.shape != (1,))):
        raise ValueError(f"cim_mac: w_codes {tuple(w_codes.shape)} / atten "
                         f"{tuple(row_atten.shape)} do not fit v "
                         f"{tuple(v.shape)}")
    lib = build.load()
    out = torch.empty((b, c), dtype=torch.float32, device=v.device)
    # the per-part sums where the launch splits the arrays across blocks
    n_scratch = lib.cim_mac_scratch(b, r, c, array_size)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=v.device)
               if n_scratch else None)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    build.check(lib.cim_mac_launch(
        v.data_ptr(), w_codes.data_ptr(), row_atten.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        None if rows_iterated is None else rows_iterated.data_ptr(),
        b, r, c, array_size, lsb, stream), "cim_mac launch")
    cim_mac.launches += 1
    return out


cim_mac.launches = 0


def cim_mac_tiled(v: torch.Tensor, w_codes: torch.Tensor,
                  gain: Optional[torch.Tensor], row_atten: torch.Tensor, *,
                  array_size: int, lsb: float,
                  rows_iterated: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Launch the kernel: v [B, R] f32, w_codes [R, C] int8, gain [R, C]
    f32 or None (ideal cells), row_atten [R] f32, all contiguous on one CUDA
    device, R a multiple of ``array_size``; ``lsb`` is the ADC step. Returns
    [B, C] int32 codes summed over row tiles. If ``rows_iterated`` (an int64
    [1] tensor on v's device) is given, the kernel adds to it the (batch
    row, row) pairs whose terms it formed, the padding of its live-row
    lists included: about B * R when every row is live, fewer where rows
    are dead for a whole group of batch rows. Counts each launch in
    ``cim_mac_tiled.launches``."""
    b, r = v.shape
    c = w_codes.shape[-1]
    tensors = dict(v=(v, torch.float32), w_codes=(w_codes, torch.int8),
                   row_atten=(row_atten, torch.float32))
    if gain is not None:
        tensors["gain"] = (gain, torch.float32)
    if rows_iterated is not None:
        tensors["rows_iterated"] = (rows_iterated, torch.int64)
    _check_inputs("cim_mac_tiled", v.device, **tensors)
    if (w_codes.shape != (r, c) or row_atten.shape != (r,)
            or (gain is not None and gain.shape != (r, c))
            or (rows_iterated is not None and rows_iterated.shape != (1,))
            or array_size < 1 or r % array_size):
        raise ValueError(f"cim_mac_tiled: w_codes {tuple(w_codes.shape)} / "
                         f"atten {tuple(row_atten.shape)} / array_size "
                         f"{array_size} do not fit v {tuple(v.shape)}")
    lib = build.load()
    out = torch.empty((b, c), dtype=torch.int32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    build.check(lib.cim_mac_tiled_launch(
        v.data_ptr(), w_codes.data_ptr(),
        None if gain is None else gain.data_ptr(), row_atten.data_ptr(),
        out.data_ptr(),
        None if rows_iterated is None else rows_iterated.data_ptr(),
        b, r, c, array_size, lsb, stream),
        "cim_mac_tiled launch")
    cim_mac_tiled.launches += 1
    return out


cim_mac_tiled.launches = 0

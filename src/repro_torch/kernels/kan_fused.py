"""Fused KAN spline layer: the wrapper of the hand-written CUDA kernel
``csrc/kan_fused.cu`` (port of the TPU kernel ``repro.kernels.kan_fused``).

The kernel fuses quantise -> PowerGap decode -> SH-LUT -> contraction
against int8 codes, so the expanded basis never reaches HBM. It runs the
contraction on the tensor cores in bf16 over an exact three-way split of
the SH-LUT taps; when the output alone does not fill the card, it splits
the inputs over blocks whose f64 partial sums go to a scratch buffer
allocated here, and adds them in a fixed order.
Its plain version is ``kernels.ref.kan_spline_ref``; ``kernels.ops`` picks
between the two by the device of the input.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.quant import ASPConfig
from repro_torch.kernels import build

MAX_SMEM = 232_448   # bytes of shared memory a block may use on Hopper
# the kernel's fixed shared memory (csrc/kan_fused.cu::smem_bytes): f64 sums
# of 256 threads x 16 tiles x 4, two bf16 B slots of 64 x 136 and two slot
# maps of 64 ints, the int8 code stage of 2 x 64 x 128
_FIXED_SMEM = 256 * 16 * 4 * 8 + 2 * (64 * 136 * 2 + 64 * 4) + 2 * 64 * 128


@functools.lru_cache(maxsize=None)
def smem_bytes(asp: ASPConfig) -> int:
    """Shared memory of one block for a config: the fixed part, the input
    codes of two k-blocks (128 rows x the inputs a 64-slot k-block can
    touch) and the split tap table, L x (K+1) entries of 8 bytes."""
    span_max = 63 // asp.n_basis + 2
    return (_FIXED_SMEM + 2 * 128 * span_max * 4
            + asp.levels_per_interval * asp.n_taps * 8)


def supported(asp: ASPConfig) -> bool:
    """Whether the kernel takes this config: its tap table fits in shared
    memory beside the rest of the block's (L x (K+1) <= 5184 at S = 10)."""
    return smem_bytes(asp) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def _asp_args(asp: ASPConfig) -> tuple:
    """The kernel's scalars for a config, computed once: (S, K+1, LD,
    n_levels, ceil(L/2), x_min, step)."""
    return (asp.n_basis, asp.n_taps, asp.ld, asp.n_levels,
            (asp.levels_per_interval + 1) // 2, asp.x_min, asp.step)


@functools.lru_cache(maxsize=None)
def _scratch_size(device_index: int, *shape: int) -> int:
    """f64 elements of split-sum scratch for (B, I, S, O) on a device (the
    kernel's own plan, asked once per shape and device)."""
    with torch.cuda.device(device_index):
        n = build.load().kan_fused_scratch(*shape)
    build.check(max(-n, 0), "kan_fused plan")
    return n


def kan_fused(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
              hemi: torch.Tensor, *, asp: ASPConfig) -> torch.Tensor:
    """Launch the kernel: x [B, I] f32, codes [I, S, O] int8, scale [O] f32,
    hemi [ceil(L/2), K+1] f32, all contiguous on one CUDA device.
    Returns y [B, O] f32. Counts each launch in ``kan_fused.launches``."""
    b, i = x.shape
    o = codes.shape[-1]
    dev = x.device
    if not supported(asp):
        raise ValueError(
            f"kan_fused: G={asp.grid_size}, K={asp.order}, L="
            f"{asp.levels_per_interval} needs {smem_bytes(asp)} bytes of "
            f"shared memory per block, over the {MAX_SMEM} a block may use")
    if dev.type != "cuda":
        raise ValueError("kan_fused: x must be on a CUDA device")
    for name, t, dtype in (("x", x, torch.float32), ("codes", codes, torch.int8),
                           ("scale", scale, torch.float32),
                           ("hemi", hemi, torch.float32)):
        if t.device != dev:
            raise ValueError(f"kan_fused: {name} must be on x's CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kan_fused: {name} must be contiguous {dtype}")
    s_, k1, ld, n_levels, half, x_min, step = _asp_args(asp)
    if codes.shape != (i, s_, o) or scale.shape != (o,):
        raise ValueError(f"kan_fused: codes {tuple(codes.shape)} / scale "
                         f"{tuple(scale.shape)} do not fit x {tuple(x.shape)}")
    if hemi.shape != (half, k1):
        raise ValueError(f"kan_fused: SH-LUT {tuple(hemi.shape)} is not "
                         f"[ceil(L/2), K+1] = [{half}, {k1}]")
    lib = build.load()
    y = torch.empty((b, o), dtype=torch.float32, device=dev)
    n_scratch = _scratch_size(dev.index, b, i, s_, o)
    scratch = (torch.empty(n_scratch, dtype=torch.float64, device=dev)
               if n_scratch else None)
    # the current stream's handle, without building a Stream object (a
    # few microseconds of host time per call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    build.check(lib.kan_fused_launch(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), hemi.data_ptr(),
        y.data_ptr(), None if scratch is None else scratch.data_ptr(), b, i,
        s_, o, k1, ld, n_levels, half, x_min, step, stream),
        "kan_fused launch")
    kan_fused.launches += 1
    return y


kan_fused.launches = 0

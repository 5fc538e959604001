"""Chunked Mamba-2 SSD scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_scan.cu`` (port of the TPU kernel ``repro.kernels.ssd_scan``).

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t ;   y_t = C_t . h_t + D x_t

per head, in chunks: the [P, N] state stays on chip across a chunk loop
inside the kernel. Unlike the TPU kernel it also takes an initial state and
returns the final one, which the serving prefill needs. Its plain versions
are ``kernels.ref.ssd_chunked_ref`` (the same chunked form) and
``kernels.ref.ssd_ref`` (the sequential recurrence); ``kernels.ops`` picks
between kernel and plain version by the device of the input.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_SMEM = 232_448   # bytes of shared memory a block may use on Hopper
P_ALIGN = 8          # the kernel takes P in slices of 8 or 16 columns


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one block: the state slice, the chunk's dt x and
    its cumsum and decay rows."""
    pb = 16 if p % 16 == 0 else 8
    return 4 * (pb * n + chunk * pb + 2 * chunk)


def supported(p: int, n: int, chunk: int) -> bool:
    return (p >= P_ALIGN and p % P_ALIGN == 0 and n >= 1 and chunk >= 1
            and smem_bytes(p, n, chunk) <= MAX_SMEM)


def _rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as given if its last dim is contiguous (the kernel takes the
    outer strides), else a contiguous copy."""
    if t.dtype != torch.float32:
        raise ValueError(f"ssd_scan: {what} must be f32, got {t.dtype}")
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor,
             d_skip: Optional[torch.Tensor], *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on f32 CUDA tensors: x [B, T, H, P], dt [B, T, H],
    a [H], b_mat/c_mat [B, T, N], d_skip [H] or None, init_state [B, H, P,
    N] or None. ``x``, ``dt``, ``b_mat`` and ``c_mat`` may be views with
    outer strides (slices of the mixer's projection are read in place).
    T need not be a multiple of ``chunk``. Returns (y [B, T, H, P],
    final_state [B, H, P, N]). Counts each launch in
    ``ssd_scan.launches``."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    if (dt.shape != (bsz, t, h) or a.shape != (h,)
            or b_mat.shape != (bsz, t, n) or c_mat.shape != (bsz, t, n)
            or (d_skip is not None and d_skip.shape != (h,))
            or (init_state is not None
                and init_state.shape != (bsz, h, p, n))):
        raise ValueError("ssd_scan: shapes do not fit x "
                         f"{tuple(x.shape)}: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(b_mat.shape)}, C "
                         f"{tuple(c_mat.shape)}")
    if not supported(p, n, chunk):
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} not "
                         f"supported (P a multiple of {P_ALIGN}, shared "
                         f"memory {smem_bytes(p, n, chunk)} <= {MAX_SMEM})")
    named = dict(x=x, dt=dt, a=a, b_mat=b_mat, c_mat=c_mat)
    if d_skip is not None:
        named["d_skip"] = d_skip
    if init_state is not None:
        named["init_state"] = init_state
    for name, tensor in named.items():
        if tensor.device != x.device or tensor.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} must be on x's CUDA device")
    x = _rows(x, "x")
    if x.stride(-2) != p:
        x = x.contiguous()
    dt, b_mat, c_mat = (_rows(dt, "dt"), _rows(b_mat, "b_mat"),
                        _rows(c_mat, "c_mat"))
    a = _rows(a, "a").contiguous()
    if d_skip is not None:
        d_skip = _rows(d_skip, "d_skip").contiguous()
    if init_state is not None:
        init_state = _rows(init_state, "init_state").contiguous()
    nc = -(-t // chunk)
    lib = build.load()
    scratch = torch.empty((bsz, nc, chunk, chunk), dtype=torch.float32,
                          device=x.device)
    y = torch.empty((bsz, t, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), None if d_skip is None else d_skip.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        scratch.data_ptr(), y.data_ptr(), final.data_ptr(), bsz, t, h, p, n,
        chunk, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        b_mat.stride(0), b_mat.stride(1), c_mat.stride(0), c_mat.stride(1),
        stream), "ssd_scan launch")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0

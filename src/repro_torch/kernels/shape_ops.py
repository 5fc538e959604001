"""Shape-only stand-ins of the five kernels, for tensors on the ``meta``
device (the dry run, ``launch.dryrun``, which builds every cell from meta
tensors and allocates nothing).

Each is a ``torch.library`` custom op whose only working implementation is
its fake one, which the dispatcher runs for meta tensors: on a CPU or CUDA
tensor it raises, so no real run can reach one. ``kernels.ops`` calls them for a meta input
in place of the plain version (CPU) or the CUDA kernel (card). Each that
computes a product also has a FLOP formula for ``torch.utils.flop_counter``
(the counting mode of ``repro_torch.analysis``): the operations the kernel
does for these shapes. ``kan_basis`` has none, as its plain version's
elementwise ops count none.
Importing this module registers the ops; ``kernels.ops`` imports it on the
first meta call.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

Tensor = torch.Tensor


def _real_data(name: str):
    raise RuntimeError(f"repro_torch::{name} is a shape-only stand-in for "
                       "meta tensors; real tensors go to the kernel or its "
                       "plain version")


@torch.library.custom_op("repro_torch::kan_fused_shape", mutates_args=())
def kan_fused_shape(x: Tensor, codes: Tensor) -> Tensor:
    """``kan_fused`` on x [B, I] and codes [I, S, O]: y [B, O] f32."""
    _real_data("kan_fused_shape")


@kan_fused_shape.register_fake
def _(x, codes):
    return x.new_empty((x.shape[0], codes.shape[-1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.kan_fused_shape)
def _kan_fused_flops(x_shape, codes_shape, *args, **kwargs) -> int:
    """The basis-times-codes product, 2 B I S O."""
    i, s, o = codes_shape
    return 2 * x_shape[0] * i * s * o


@torch.library.custom_op("repro_torch::kan_basis_shape", mutates_args=())
def kan_basis_shape(x: Tensor, n_basis: int) -> Tensor:
    """``kan_basis`` on x [M, I]: the dense basis [M, I, n_basis] f32."""
    _real_data("kan_basis_shape")


@kan_basis_shape.register_fake
def _(x, n_basis):
    return x.new_empty((x.shape[0], x.shape[1], n_basis),
                       dtype=torch.float32)


@torch.library.custom_op("repro_torch::cim_mac_shape", mutates_args=())
def cim_mac_shape(v: Tensor, w_codes: Tensor, tiled: bool) -> Tensor:
    """``cim_mac`` (f32) or ``cim_mac_tiled`` (int32 codes) on v [B, R]
    and w_codes [R, C]: [B, C]."""
    _real_data("cim_mac_shape")


@cim_mac_shape.register_fake
def _(v, w_codes, tiled):
    return v.new_empty((v.shape[0], w_codes.shape[-1]),
                       dtype=torch.int32 if tiled else torch.float32)


@register_flop_formula(torch.ops.repro_torch.cim_mac_shape)
def _cim_mac_flops(v_shape, w_shape, *args, **kwargs) -> int:
    """Eight bit planes of the R x C product, 2 B R C each."""
    return 8 * 2 * v_shape[0] * w_shape[0] * w_shape[1]


@torch.library.custom_op("repro_torch::ssd_scan_shape", mutates_args=())
def ssd_scan_shape(x: Tensor, b_mat: Tensor, chunk: int
                   ) -> Tuple[Tensor, Tensor]:
    """``ssd_scan`` on x [B, T, H, P] and B [B, T, N]: (y [B, T, H, P],
    final state [B, H, P, N]), both f32."""
    _real_data("ssd_scan_shape")


@ssd_scan_shape.register_fake
def _(x, b_mat, chunk):
    b, t, h, p = x.shape
    n = b_mat.shape[-1]
    return (x.new_empty((b, t, h, p), dtype=torch.float32),
            x.new_empty((b, h, p, n), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_shape)
def _ssd_scan_flops(x_shape, b_shape, chunk, *args, **kwargs) -> int:
    """The chunked scan's operations: C B^T over each chunk's lower
    triangle, per head the masked decay and the intra-chunk product, the
    carry-in readout and state update over (t, p, n), the elementwise
    terms."""
    b, t, h, p = x_shape
    n = b_shape[-1]
    tri = sum(l * (l + 1) // 2 for l in
              (min(chunk, t - c0) for c0 in range(0, t, chunk)))
    return int(2 * b * tri * n + b * h * tri * (3 + 2 * p)
               + 4 * b * t * h * p * n + 6 * b * t * h * p + 3 * b * t * h)

"""Public wrappers around the hand-written kernels (port of
``repro.kernels.ops``).

Each wrapper checks device, dtype, shape and contiguity, flattens leading
batch dims, and then takes exactly one path by the input's device: the
plain PyTorch version on the CPU, the CUDA kernel on the card, and on the
``meta`` device (the dry run) the kernel's shape-only stand-in
(``kernels.shape_ops``, registered for meta tensors alone). There is no
other branch and no fallback. The kernels count their launches;
``launch_counts``/``reset_launch_counts`` read and clear those counts.

``kan_spline_fused`` is the QAT autograd Function around the fused kernel
(forward: quantised coefficients through the kernel; backward in plain
torch: the straight-through float path for x, the exact quantised expanded
basis for the coefficients). ``ssd_state`` on the card is the same
arrangement when an input requires a gradient: the ``ssd_scan`` kernel
forward, and a backward that recomputes the plain chunked form and returns
its VJP (the reference trains through that form, which JAX differentiates).

Under a mesh (DTensor inputs, ``dist.sharding``) ``kan_spline_fused`` and
``ssd_state`` run on each rank's local shard through ``local_map``: the
kernel splits only the batch rows and the output channels
(``kan_spline_fused``) or the batch and the heads (``ssd``); the
reduction dim (I·S) and every quantisation statistic stay whole on each
rank. An input replicated over a mesh dim on which the kernel runs on
shards of another input gets a partial gradient there, which
``local_map`` is told (``in_grad_placements``): by default it would take
the local gradient as the whole one.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import quant, splines
from repro_torch.core.quant import ASPConfig
from repro_torch.dist.sharding import as_dtensors, placements_of
from repro_torch.kernels import cim_mac as _cim
from repro_torch.kernels import kan_fused as _kf
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


_KERNELS = {"kan_fused": _kf.kan_fused, "cim_mac": _cim.cim_mac,
            "cim_mac_tiled": _cim.cim_mac_tiled, "ssd_scan": _ssd.ssd_scan}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
    _ssd.ssd_scan.init_launches = 0


def _same_device(what: str, ref_t: torch.Tensor, **tensors) -> None:
    if ref_t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {ref_t.device}")
    for name, t in tensors.items():
        if t.device != ref_t.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the input "
                             f"on {ref_t.device}")


def _shape_ops():
    """The kernels' shape-only stand-ins for meta tensors (registered on
    first use)."""
    from repro_torch.kernels import shape_ops
    return shape_ops


def kan_spline_fused_deployed(x: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor, asp: ASPConfig,
                              hemi: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Deployed-path fused spline forward: frozen int8 codes, per-output-
    channel scales and the artifact's SH-LUT go straight to the kernel (no
    requantisation). What the ``fused`` backend runs at serving time.

    x: [..., I] float (bounded); codes: [I, S, O] int8 contiguous; scale:
    O elements. Returns [..., O] in x.dtype.
    """
    lead, i, o = x.shape[:-1], x.shape[-1], codes.shape[-1]
    if hemi is None:
        hemi = quant.hemi_for(asp, x.device)
    _same_device("kan_spline_fused_deployed", x, codes=codes, scale=scale,
                 hemi=hemi)
    if codes.dtype != torch.int8 or codes.shape != (i, asp.n_basis, o):
        raise ValueError(f"codes must be int8 [{i}, {asp.n_basis}, {o}], "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    if scale.numel() != o:
        raise ValueError(f"scale has {scale.numel()} elements for O={o}")
    if not (codes.is_contiguous() and hemi.is_contiguous()):
        raise ValueError("codes and hemi must be contiguous")
    # the serving path passes f32 [B, I] and [O] already: leave those as
    # they are, since this runs once per layer call on the host
    flat_f32 = x.dim() == 2 and x.dtype == torch.float32
    xf = x if flat_f32 and x.is_contiguous() else \
        x.reshape(-1, i).to(torch.float32).contiguous()
    if scale.dim() != 1 or scale.dtype != torch.float32 or \
            not scale.is_contiguous():
        scale = scale.reshape(o).to(torch.float32).contiguous()
    if x.device.type == "cpu":
        y = ref.kan_spline_ref(xf, codes, scale, asp, hemi)
    elif x.device.type == "meta":
        y = _shape_ops().kan_fused_shape(xf, codes)
    else:
        y = _kf.kan_fused(xf, codes, scale, hemi.to(torch.float32), asp=asp)
    return y if flat_f32 else y.reshape(lead + (o,)).to(x.dtype)


class _KanSplineFused(torch.autograd.Function):
    """Forward quantised through the fused kernel, straight-through
    backward (``repro.kernels.ops.kan_spline_fused``'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, coeffs, asp):
        codes, scale = quant.quantize_coeffs(coeffs, asp, axis=(0, 1))
        ctx.asp = asp
        ctx.save_for_backward(x, coeffs)
        return kan_spline_fused_deployed(x, codes, scale, asp)

    @staticmethod
    def backward(ctx, dy):
        x, coeffs = ctx.saved_tensors
        asp = ctx.asp
        dyf = dy.to(torch.float32)
        xf = x.to(torch.float32)
        n_i, n_s, n_o = coeffs.shape
        dx = dcoeffs = None
        if ctx.needs_input_grad[1]:
            # the exact quantised expanded basis: d/dcoeffs of E @ C
            eq = quant.quantized_basis(xf, quant.hemi_for(asp, x.device), asp)
            dcoeffs = (eq.reshape(-1, n_i * n_s).T @ dyf.reshape(-1, n_o)
                       ).reshape(coeffs.shape).to(coeffs.dtype)
        if ctx.needs_input_grad[0]:
            # the float cardinal path's derivative (an encoder's input is
            # data, whose float basis at full width is not built)
            with torch.enable_grad():
                xx = xf.detach().requires_grad_()
                basis = splines.bspline_basis_uniform(
                    xx, asp.x_min, asp.x_max, asp.grid_size, asp.order)
                y = torch.einsum("...is,iso->...o", basis,
                                 coeffs.to(torch.float32))
                (dx,) = torch.autograd.grad(y, xx, dyf)
            dx = dx.to(x.dtype)
        return dx, dcoeffs, None


def _kan_spline_fused_mesh(mesh, x, coeffs, asp: ASPConfig):
    """``_KanSplineFused`` on each rank's shard: per mesh dim, x's batch
    rows stay split if they are (coeffs replicated there, their gradient
    partial), else the coefficients' output channels stay split if they
    are (x replicated there, its gradient partial), else both replicate.
    The coefficients' I and S are whole, so each output channel's scale is
    the unsharded one."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    nd = x.ndim
    xp, cp, yp, xg, cg = [], [], [], [], []
    for px, pc in zip(placements_of(x), placements_of(coeffs)):
        if px.is_shard() and px.dim < nd - 1:
            col = (px, Replicate(), px, px, Partial())
        elif pc.is_shard(2):
            col = (Replicate(), Shard(2), Shard(nd - 1), Partial(), Shard(2))
        else:
            col = (Replicate(),) * 5
        for lst, pl in zip((xp, cp, yp, xg, cg), col):
            lst.append(pl)
    fn = local_map(lambda a, c: _KanSplineFused.apply(a, c, asp),
                   out_placements=yp, in_placements=(xp, cp),
                   in_grad_placements=(xg, cg), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(x, coeffs)


def kan_spline_fused(x: torch.Tensor, coeffs: torch.Tensor, asp: ASPConfig
                     ) -> torch.Tensor:
    """Quantised fused spline for training: x [..., I] float (bounded),
    coeffs [I, S, O] float. The forward quantises the coefficients
    (``quantize_coeffs(..., axis=(0, 1))``) and runs the deployed wrapper:
    the CUDA kernel on the card, its plain version on the CPU. The backward
    is the straight-through estimator: d/dx through the float cardinal path,
    d/dcoeffs the quantised expanded basis times dy. Returns [..., O] in
    x.dtype; the gradients come back in their inputs' dtypes. DTensor
    inputs run on each rank's shard (``_kan_spline_fused_mesh``)."""
    mesh, (x, coeffs) = as_dtensors(x, coeffs)
    if mesh is not None:
        return _kan_spline_fused_mesh(mesh, x, coeffs, asp)
    return _KanSplineFused.apply(x, coeffs, asp)


def cim_mac(v: torch.Tensor, w_codes: torch.Tensor, row_atten: torch.Tensor,
            *, array_size: int, adc_bits: int = 8, in_scale: float = 1.0,
            rows_iterated: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bit-sliced ACIM MAC. v: [..., R] float, w_codes: [R, C] int8
    contiguous, row_atten: [R] float. A ragged final array counts as dead
    (atten 0) rows. Returns [..., C] f32. The kernel adds the (batch row,
    row) pairs whose terms it formed to ``rows_iterated`` (an int64 [1]
    tensor on v's card) if given; the plain versions count nothing."""
    lead, r, c = v.shape[:-1], v.shape[-1], w_codes.shape[-1]
    _same_device("cim_mac", v, w_codes=w_codes, row_atten=row_atten)
    if w_codes.dtype != torch.int8 or w_codes.shape != (r, c):
        raise ValueError(f"w_codes must be int8 [{r}, C], got "
                         f"{w_codes.dtype} {tuple(w_codes.shape)}")
    if not w_codes.is_contiguous():
        raise ValueError("w_codes must be contiguous")
    if row_atten.shape != (r,):
        raise ValueError(f"row_atten must be [{r}], got "
                         f"{tuple(row_atten.shape)}")
    vf = v.reshape(-1, r).to(torch.float32).contiguous()
    att = row_atten.to(torch.float32).contiguous()
    if v.device.type == "cpu":
        y = ref.cim_mac_ref(vf, w_codes, att, array_size, adc_bits, in_scale)
    elif v.device.type == "meta":
        y = _shape_ops().cim_mac_shape(vf, w_codes, False)
    else:
        # the ADC step as the reference computes it: a Python float that
        # the kernel receives rounded to f32
        lsb = float(array_size) * in_scale / float(2 ** adc_bits - 1)
        y = _cim.cim_mac(vf, w_codes, att, array_size=array_size, lsb=lsb,
                         rows_iterated=rows_iterated)
    return y.reshape(lead + (c,))


def cim_mac_tiled(v: torch.Tensor, w_codes: torch.Tensor,
                  row_atten: torch.Tensor, *,
                  gain: Optional[torch.Tensor] = None, array_size: int,
                  adc_bits: int = 8, in_scale: float = 1.0,
                  rows_iterated: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Multi-tile ACIM MAC (``hw.tiles``). v: [..., R] float PHYSICAL-order
    WL values, w_codes: [R, C] int8 contiguous, row_atten: [R] float, gain:
    optional [R, C] per-cell conductance multipliers (None = ideal cells).
    R must already be a tile multiple (the chip mapper pads rows). Returns
    [..., C] int32: the per-tile readout codes reduced over row tiles (the
    caller scales by the LSB). ``rows_iterated`` as for ``cim_mac``."""
    lead, r, c = v.shape[:-1], v.shape[-1], w_codes.shape[-1]
    if r % array_size:
        raise ValueError(f"R={r} not a multiple of array_size={array_size} "
                         "(the chip mapper pads rows to whole tiles)")
    extra = {} if gain is None else {"gain": gain}
    _same_device("cim_mac_tiled", v, w_codes=w_codes, row_atten=row_atten,
                 **extra)
    if w_codes.dtype != torch.int8 or w_codes.shape != (r, c):
        raise ValueError(f"w_codes must be int8 [{r}, C], got "
                         f"{w_codes.dtype} {tuple(w_codes.shape)}")
    if not w_codes.is_contiguous():
        raise ValueError("w_codes must be contiguous")
    if row_atten.shape != (r,):
        raise ValueError(f"row_atten must be [{r}], got "
                         f"{tuple(row_atten.shape)}")
    if gain is not None and gain.shape != (r, c):
        raise ValueError(f"gain must be [{r}, {c}], got {tuple(gain.shape)}")
    vf = v.reshape(-1, r).to(torch.float32).contiguous()
    att = row_atten.to(torch.float32).contiguous()
    g = None if gain is None else gain.to(torch.float32).contiguous()
    if v.device.type == "cpu":
        y = ref.cim_mac_tiled_ref(vf, w_codes, g, att, array_size, adc_bits,
                                  in_scale)
    elif v.device.type == "meta":
        y = _shape_ops().cim_mac_shape(vf, w_codes, True)
    else:
        lsb = float(array_size) * in_scale / float(2 ** adc_bits - 1)
        y = _cim.cim_mac_tiled(vf, w_codes, g, att, array_size=array_size,
                               lsb=lsb, rows_iterated=rows_iterated)
    return y.reshape(lead + (c,))


def ssd_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b_mat: torch.Tensor, c_mat: torch.Tensor,
              d_skip: Optional[torch.Tensor] = None, *, chunk: int = 64,
              init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba-2 SSD with its state. x: [B, T, H, P]; dt: [B, T, H]
    (> 0); a: [H] (< 0); b_mat/c_mat: [B, T, N]; d_skip: [H] or None;
    init_state: [B, H, P, N] or None. Returns (y [B, T, H, P] f32,
    final_state [B, H, P, N] f32). T is taken as padded to a whole chunk
    with dt = 0 rows (exact no-ops): the plain version pads, the kernel
    masks the rows past T, which is the same. DTensor inputs run on each
    rank's shard (``_ssd_state_mesh``)."""
    mesh, ins = as_dtensors(x, dt, a, b_mat, c_mat, d_skip, init_state)
    if mesh is not None:
        return _ssd_state_mesh(mesh, *ins, chunk=chunk)
    extra = {} if d_skip is None else {"d_skip": d_skip}
    if init_state is not None:
        extra["init_state"] = init_state
    _same_device("ssd", x, dt=dt, a=a, b_mat=b_mat, c_mat=c_mat, **extra)
    if chunk < 1:
        raise ValueError(f"ssd: chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_skip,
                                   chunk=chunk, init_state=init_state)
    inputs = (x, dt, a, b_mat, c_mat, d_skip, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _SsdScan.apply(*inputs, chunk)
    return _ssd_scan_f32(*inputs, chunk)


def _ssd_state_mesh(mesh, x, dt, a, b_mat, c_mat, d_skip, init_state, *,
                    chunk: int):
    """``ssd_state`` on each rank's shard: per mesh dim, the batch stays
    split if x's is (a and d_skip replicated there, their gradients
    partial), else the heads stay split if x's are (B and C replicated
    there, their gradients partial), else everything replicates. Each
    rank's scan is then the unsharded scan of its rows and heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    R, P = Replicate(), Partial()
    # x, dt, a, B, C, d_skip, init_state; then y, final
    batch = (Shard(0), Shard(0), R, Shard(0), Shard(0), R, Shard(0))
    batch_g = (Shard(0), Shard(0), P, Shard(0), Shard(0), P, Shard(0))
    heads = (Shard(2), Shard(2), Shard(0), R, R, Shard(0), Shard(1))
    heads_g = (Shard(2), Shard(2), Shard(0), P, P, Shard(0), Shard(1))
    rep = (R,) * 7
    cols = []
    for px in placements_of(x):
        if px.is_shard(0):
            cols.append((batch, batch_g, (Shard(0), Shard(0))))
        elif px.is_shard(2):
            cols.append((heads, heads_g, (Shard(2), Shard(1))))
        else:
            cols.append((rep, rep, (R, R)))
    ins = (x, dt, a, b_mat, c_mat, d_skip, init_state)
    in_pl = tuple(None if ins[j] is None else [c[0][j] for c in cols]
                  for j in range(7))
    in_g = tuple(None if ins[j] is None else [c[1][j] for c in cols]
                 for j in range(7))
    out_pl = tuple([c[2][j] for c in cols] for j in range(2))

    def local(xl, dtl, al, bl, cl, dl, il):
        return ssd_state(xl, dtl, al, bl, cl, dl, chunk=chunk, init_state=il)
    fn = local_map(local, out_placements=out_pl, in_placements=in_pl,
                   in_grad_placements=in_g, device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*ins)


def _ssd_scan_f32(x, dt, a, b_mat, c_mat, d_skip, init_state, chunk):
    """The kernel on f32 copies (or the tensors themselves) of its inputs;
    its shape-only stand-in on meta tensors."""
    if x.device.type == "meta":
        return _shape_ops().ssd_scan_shape(x, b_mat, chunk)
    f32 = torch.float32
    return _ssd.ssd_scan(
        x.to(f32), dt.to(f32), a.to(f32), b_mat.to(f32), c_mat.to(f32),
        None if d_skip is None else d_skip.to(f32), chunk=chunk,
        init_state=None if init_state is None else init_state.to(f32))


class _SsdScan(torch.autograd.Function):
    """``ssd_scan`` forward; the backward recomputes the plain chunked form
    (``ref.ssd_chunked_ref``) from the saved inputs under autograd and
    returns its VJP for x, dt, a, B, C, d_skip and init_state (each in its
    input's dtype). Neither package has a backward kernel for the scan."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, d_skip, init_state, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, d_skip, init_state)
        return _ssd_scan_f32(x, dt, a, b_mat, c_mat, d_skip, init_state,
                             chunk)

    @staticmethod
    def backward(ctx, dy, dfinal):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            inputs = [None if t is None else
                      t.detach().requires_grad_(need[i])
                      for i, t in enumerate(ctx.saved_tensors)]
            y, final = ref.ssd_chunked_ref(*inputs[:6], chunk=ctx.chunk,
                                           init_state=inputs[6])
            wrt = [t for i, t in enumerate(inputs) if need[i]]
            grads = iter(torch.autograd.grad((y, final), wrt, (dy, dfinal),
                                             allow_unused=True))
        return tuple(next(grads) if need[i] else None
                     for i in range(7)) + (None,)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b_mat: torch.Tensor, c_mat: torch.Tensor, d_skip: torch.Tensor, *,
        chunk: int = 64) -> torch.Tensor:
    """Padded wrapper of the chunked SSD kernel (``repro.kernels.ops.ssd``'s
    signature). x: [B, T, H, P]; dt: [B, T, H]; a/d_skip: [H]; b/c:
    [B, T, N]. Returns y [B, T, H, P] f32; T is padded to a chunk multiple
    with dt = 0 rows (zero step size -> decay 1, zero input: exact
    no-ops)."""
    return ssd_state(x, dt, a, b_mat, c_mat, d_skip, chunk=chunk)[0]

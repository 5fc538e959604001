"""Plain PyTorch versions of the hand-written kernels (port of
``repro.kernels.ref``).

Each kernel in ``kernels/`` is held against its plain version here: on the
CPU the wrappers in ``ops`` run these, and on the card ``chip_smoke.py``
compares the kernel with them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant, splines
from repro_torch.core.quant import ASPConfig


def kan_spline_ref(x: torch.Tensor, c_codes: torch.Tensor,
                   scale: torch.Tensor, asp: ASPConfig,
                   hemi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the fused KAN spline layer.

    x: [B, I] float (already bounded to the knot range); c_codes: [I, G+K, O]
    int8; scale: [O] float. Returns [B, O] f32: (E @ codes) * scale with the
    expanded basis E materialised.
    """
    if hemi is None:
        hemi = quant.hemi_for(asp, x.device)
    basis = quant.quantized_basis(x, hemi, asp)        # [B, I, G+K]
    e = basis.reshape(x.shape[0], -1).to(torch.float32)
    c = c_codes.to(torch.float32).reshape(e.shape[1], -1)
    return (e @ c) * scale[None, :]


def kan_spline_dx_f64(x: torch.Tensor, coeffs: torch.Tensor,
                      asp: ASPConfig, dy: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 version of the QAT spline's d/dx (``ops.kan_spline_fused``'s
    straight-through backward): the derivative of the float cardinal path
    ``einsum(bspline_basis_uniform(x), coeffs)`` against ``dy``, and the sum
    of its terms' magnitudes. Each input's basis depends on it alone, so one
    forward-mode pass gives every dB/dx.

    x: [B, I] (bounded); coeffs: [I, S, O]; dy: [B, O]. Returns two [B, I]
    float64 tensors.
    """
    def basis(z):
        return splines.bspline_basis_uniform(z, asp.x_min, asp.x_max,
                                             asp.grid_size, asp.order)
    xx = x.double()
    db = torch.func.jvp(basis, (xx,), (torch.ones_like(xx),))[1]
    c, d = coeffs.double(), dy.double()
    return (torch.einsum("bis,iso,bo->bi", db, c, d),
            torch.einsum("bis,iso,bo->bi", db.abs(), c.abs(), d.abs()))


def cim_mac_ref(v: torch.Tensor, w_codes: torch.Tensor,
                row_atten: torch.Tensor, array_size: int, adc_bits: int,
                in_scale: float = 1.0) -> torch.Tensor:
    """Plain version of the bit-sliced ACIM MAC.

    For each physical array of ``array_size`` rows and each bit k < 8:
    ``psum_k = (v*atten) @ (bit_k(|w|) * sign(w))``, read out by the ADC as
    ``round(psum_k / lsb) * lsb`` (half to even), recombined as
    ``sum_k 2^k * readout``. A ragged final array is padded with dead rows.

    The ADC rounding makes the result depend on the f32 summation order of
    each psum (a psum near .5 LSB flips a whole step). The rows of an array
    are therefore added one at a time in row order, as the CUDA kernel adds
    them, so the two give bit-identical psums and readouts.

    v: [B, R] float; w_codes: [R, C] int8; row_atten: [R] float.
    Returns [B, C] f32.
    """
    b, r = v.shape
    c = w_codes.shape[1]
    n_arrays = -(-r // array_size)
    pad = n_arrays * array_size - r
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, pad))
    wf = torch.nn.functional.pad(w_codes.to(torch.int32), (0, 0, 0, pad))
    att = torch.nn.functional.pad(row_atten.to(torch.float32), (0, pad))

    mag = torch.abs(wf)
    sgn = torch.sign(wf).to(torch.float32)
    va = (vf * att[None, :]).reshape(b, n_arrays, array_size)
    shifts = torch.arange(8, dtype=torch.int32, device=v.device)
    bits = ((mag[None] >> shifts[:, None, None]) & 1).to(torch.float32)
    bits = (bits * sgn[None]).reshape(8, n_arrays, array_size, c)

    fs = float(array_size) * in_scale                 # ADC full scale
    lsb = fs / (2 ** adc_bits - 1)

    psum = torch.zeros((8, b, n_arrays, c), dtype=torch.float32,
                       device=v.device)
    for j in range(array_size):                       # row order
        psum.addcmul_(va[None, :, :, j, None], bits[:, None, :, j, :])
    lsb_t = torch.full((), lsb, dtype=torch.float32, device=v.device)
    psum_q = torch.round(psum / lsb_t) * lsb_t        # per-array ADC readout
    out = torch.zeros((b, c), dtype=torch.float32, device=v.device)
    for k in range(8):
        out = out + (2.0 ** k) * psum_q[k].sum(dim=1)
    return out


def cim_mac_tiled_codes(v: torch.Tensor, w_codes: torch.Tensor,
                        gain: Optional[torch.Tensor],
                        row_atten: torch.Tensor, array_size: int,
                        adc_bits: int, in_scale: float = 1.0, *,
                        sigma_psum: float = 0.0,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Per-row-tile readout codes of the multi-tile ACIM MAC.

    For each row tile of ``array_size`` rows and each bit k < 8:
    ``psum_k = sum_r fl(v*atten)[b, r] * (bit_k(|w|) * sign(w) * gain)[r, c]``
    and ``code_k = round(psum_k / lsb)`` (half to even, int32), recombined as
    ``sum_k code_k << k``. Rows are added one at a time in row order, as the
    CUDA kernel adds them: a different f32 order can move a psum across a .5
    LSB boundary. ``psum = psum + term`` is kept as two roundings (the
    product, then the sum); ``addcmul_`` may fuse them on the CPU.

    ``generator`` adds pre-ADC readout noise, ``sigma_psum`` LSBs per
    (tile, bit slice): one draw per bit slice on the generator's device.

    v: [B, R] float; w_codes: [R, C] int8; gain: optional [R, C] float
    (None = ideal cells); row_atten: [R]; R a multiple of ``array_size``.
    Returns [B, R / array_size, C] int32.
    """
    b, r = v.shape
    c = w_codes.shape[1]
    tr = r // array_size
    va = (v.to(torch.float32) * row_atten.to(torch.float32)[None, :]
          ).reshape(b, tr, array_size)
    w = w_codes.to(torch.int32)
    mag = torch.abs(w)
    sgn = torch.sign(w).to(torch.float32)
    if gain is not None:
        sgn = sgn * gain.to(torch.float32)            # exact: +-gain or 0
    shifts = torch.arange(8, dtype=torch.int32, device=v.device)
    wbit = ((mag[None] >> shifts[:, None, None]) & 1).to(torch.float32)
    wbit = (wbit * sgn[None]).reshape(8, tr, array_size, c)

    psum = torch.zeros((8, b, tr, c), dtype=torch.float32, device=v.device)
    for j in range(array_size):                       # row order
        psum = psum + va[None, :, :, j, None] * wbit[:, None, :, j, :]
    lsb = float(array_size) * in_scale / float(2 ** adc_bits - 1)
    if generator is not None:
        for k in range(8):
            noise = torch.randn(psum.shape[1:], generator=generator,
                                device=generator.device)
            psum[k] = psum[k] + (sigma_psum * lsb) * noise.to(v.device)
    lsb_t = torch.full((), lsb, dtype=torch.float32, device=v.device)
    codes = torch.round(psum / lsb_t).to(torch.int32)  # per-tile ADC readout
    weights = (torch.ones_like(shifts) << shifts).reshape(8, 1, 1, 1)
    return (codes * weights).sum(0, dtype=torch.int32)


def cim_mac_tiled_ref(v: torch.Tensor, w_codes: torch.Tensor,
                      gain: Optional[torch.Tensor], row_atten: torch.Tensor,
                      array_size: int, adc_bits: int,
                      in_scale: float = 1.0) -> torch.Tensor:
    """Plain version of the multi-tile ACIM MAC: the per-tile readout codes
    (``cim_mac_tiled_codes``) reduced over row tiles in int32, which is
    exact in any order. Returns [B, C] int32."""
    return cim_mac_tiled_codes(v, w_codes, gain, row_atten, array_size,
                               adc_bits, in_scale).sum(1, dtype=torch.int32)


def cim_mac_ideal(v: torch.Tensor, w_codes: torch.Tensor) -> torch.Tensor:
    """Noise-free digital MAC for degradation comparisons."""
    return v.to(torch.float32) @ w_codes.to(torch.float32)



# ---------------------------------------------------------------------------
# ssd: Mamba-2 state-space duality
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b_mat: torch.Tensor, c_mat: torch.Tensor,
            d_skip: Optional[torch.Tensor] = None,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-scan oracle of the chunked SSD.

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t (x) B_t ;  y_t = h_t @ C_t

    x [B, T, H, P], dt [B, T, H] (> 0), a [H] (< 0), b_mat/c_mat [B, T, N]
    (shared across heads: n_groups = 1), d_skip [H] optional, init_state
    [B, H, P, N] optional. Returns (y [B, T, H, P], final_state
    [B, H, P, N]), both f32.
    """
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.to(torch.float32))
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf, cf = b_mat.to(torch.float32), c_mat.to(torch.float32)
    af = a.to(torch.float32)
    ys = []
    for s in range(t):
        decay = torch.exp(dtf[:, s] * af[None, :])                 # [B, H]
        upd = ((dtf[:, s, :, None] * xf[:, s])[..., None]
               * bf[:, s, None, None, :])
        state = decay[..., None, None] * state + upd               # [B,H,P,N]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, s]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.to(torch.float32)[None, None, :, None] * xf
    return y, state


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor,
                    d_skip: Optional[torch.Tensor] = None, *,
                    chunk: int = 64,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``ssd_scan`` kernel: the chunked form of
    ``repro.models.ssd.ssd_chunked`` (Dao & Gu 2024). T is padded to a whole
    chunk with dt = 0 rows (decay 1, zero input: exact no-ops).

    XLA contracts the JAX form's three-operand einsums in its own order;
    here every product is written pairwise, so no intermediate is larger
    than [B, nc, cl, cl, H] (a three-operand ``torch.einsum`` may build a
    larger one). The two differ by f32 summation order only.

    Returns (y [B, T, H, P], final_state [B, H, P, N]), both f32.
    """
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    tp = t + pad
    nc, cl = tp // chunk, chunk

    xf = x.to(torch.float32).reshape(bsz, nc, cl, h, p)
    dtf = dt.to(torch.float32).reshape(bsz, nc, cl, h)
    bf = b_mat.to(torch.float32).reshape(bsz, nc, cl, n)
    cf = c_mat.to(torch.float32).reshape(bsz, nc, cl, n)

    da = dtf * a.to(torch.float32)[None, None, None, :]   # [B,nc,cl,H] <= 0
    cs = torch.cumsum(da, dim=2)                          # inclusive
    seg_end = cs[:, :, -1, :]                             # [B,nc,H]
    xdt = xf * dtf[..., None]                             # [B,nc,cl,H,P]

    # intra-chunk: L[i,j,h] = exp(cs_i - cs_j) for i >= j. For i < j the
    # difference is positive and exp() overflows to inf, so it is replaced
    # by -inf before the exp: the same zeros as selecting exp(diff) away,
    # and a finite gradient (selecting after the exp back-propagates
    # 0 * inf = NaN through the overflowed entries)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # [B,nc,cl,cl,H]
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  torch.full((), -math.inf,
                                             device=x.device)))
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)      # [B,nc,cl,cl]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * l_mat,
                          xdt)
    del diff, l_mat

    # per-chunk input state: sum_j exp(seg_end - cs_j) xdt_j (x) B_j
    decay_out = torch.exp(seg_end[:, :, None, :] - cs)    # [B,nc,cl,H]
    state_c = torch.einsum("bcjhp,bcjn->bchpn", xdt * decay_out[..., None],
                           bf)

    # inter-chunk recurrence over the chunk index
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.to(torch.float32))
    chunk_decay = torch.exp(seg_end)                      # [B,nc,H]
    s_in = []
    for c in range(nc):
        s_in.append(s)                                    # state BEFORE c
        s = chunk_decay[:, c, :, None, None] * s + state_c[:, c]
    s_in = torch.stack(s_in, dim=1)                       # [B,nc,H,P,N]

    # off-diagonal: the carried-in state read out inside the chunk
    decay_in = torch.exp(cs)                              # [B,nc,cl,H]
    y_off = (torch.einsum("bchpn,bcin->bcihp", s_in, cf)
             * decay_in[..., None])

    y = (y_diag + y_off).reshape(bsz, tp, h, p)[:, :t]
    if d_skip is not None:
        y = y + (d_skip.to(torch.float32)[None, None, :, None]
                 * x.to(torch.float32)[:, :t])
    return y, s

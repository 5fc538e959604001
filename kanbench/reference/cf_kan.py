"""CF-KAN's deployed forward (paper §4), worked out again from the float
parameters: two KAN layers, n_items -> hidden -> n_items, each the bounded
input's quantised spline against int8 coefficient codes and one scale per
output channel, plus the ``relu(x) @ w_base`` branch. The spline runs on
one of three substrates: the digital contraction (float64 here), one
monolithic crossbar per As rows with KAN-SAM's attenuation, or the
multi-tile chip with its placement and variation gains.

Set-up (``build``) repeats what the program derives from the parameters:
the codes and scales, the SH-LUT, KAN-SAM's Phase-A statistics from the
same sample and its row mapping, the chip's placement and gains. It reads
the float parameters and the sample, never the program's artifact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kanbench.reference import asp, crossbar

# f64 basis rows per block in the digital contraction
_ROWS = 256


@dataclasses.dataclass(frozen=True)
class Hardware:
    """The substrate: ``kind`` is ``digital``, ``crossbar`` or ``chip``."""
    kind: str
    xbar: Optional[crossbar.Crossbar] = None
    sam: bool = False
    seed: int = 0                    # the chip instance (variation draw)


@dataclasses.dataclass(frozen=True)
class Layer:
    sp: asp.Spline
    table: torch.Tensor              # [L, K+1] f32 taps of each local code
    codes: torch.Tensor              # [I, S, O] int8
    scale: torch.Tensor              # [O] f32
    w_base: torch.Tensor             # [I, O] f32
    atten: Optional[torch.Tensor] = None          # crossbar: [R] logical
    placement: Optional[crossbar.Placement] = None  # chip


def splines(model: Dict) -> Tuple[asp.Spline, asp.Spline]:
    """The encoder's and decoder's spline families of a configuration."""
    return tuple(asp.Spline(grid_size=model[f"grid_size_{n}"],
                            order=model["order"], n_bits=model["n_bits"],
                            coeff_bits=model["coeff_bits"],
                            x_min=model["x_min"], x_max=model["x_max"])
                 for n in ("enc", "dec"))


def _lut_forward(xb: torch.Tensor, sp: asp.Spline, table: torch.Tensor,
                 coeffs: torch.Tensor, w_base: torch.Tensor) -> torch.Tensor:
    """The training-path forward over float coefficients, in f32: the
    quantised basis times the coefficients, plus the base branch."""
    e = asp.dense_basis(xb, sp, table)
    n = e.shape[0]
    return (e.reshape(n, -1) @ coeffs.reshape(-1, coeffs.shape[-1])
            + torch.relu(xb) @ w_base)


def _phase_a(params: Dict, sps, tables, sample: Sequence[torch.Tensor]
             ) -> List[crossbar.RowStats]:
    """KAN-SAM's Phase A over the sample: the encoder's rows from the bounded
    users, the decoder's from the bounded hidden state of the float model."""
    dev = sample[0].device
    enc, dec = params["enc"], params["dec"]
    st = [crossbar.RowStats.empty(enc["coeffs"].shape[0], sps[0].n_basis,
                                  dev),
          crossbar.RowStats.empty(dec["coeffs"].shape[0], sps[1].n_basis,
                                  dev)]
    for x in sample:
        xb = asp.bound(x, sps[0])
        st[0] = st[0].add(asp.dense_basis(xb, sps[0], tables[0]))
        h = _lut_forward(xb, sps[0], tables[0], enc["coeffs"], enc["w_base"])
        st[1] = st[1].add(asp.dense_basis(asp.bound(h, sps[1]), sps[1],
                                          tables[1]))
    return st


def build(params: Dict, model: Dict, hw: Hardware,
          sample: Sequence[torch.Tensor] = ()) -> List[Layer]:
    """The reference's own artifact from the float parameters ``{"enc":
    {"coeffs", "w_base"}, "dec": ...}``; ``sample`` is the Phase-A sample
    (KAN-SAM only)."""
    sps = splines(model)
    dev = params["enc"]["coeffs"].device
    tables = [asp.tap_table(sp, dev) for sp in sps]
    stats = _phase_a(params, sps, tables, sample) if hw.sam else None
    layers = []
    for i, name in enumerate(("enc", "dec")):
        p = params[name]
        codes, scale = asp.quantize_coeffs(p["coeffs"], sps[i])
        crit = (crossbar.criticality(stats[i], codes)
                if stats is not None else None)
        atten = placement = None
        if hw.kind == "crossbar":
            atten = crossbar.row_attenuation(codes.shape[0] * codes.shape[1],
                                             hw.xbar, dev)
            if crit is not None:
                atten = crossbar.sam_attenuation(crit, atten)
        elif hw.kind == "chip":
            placement = crossbar.place(codes, crit, hw.xbar, hw.seed, i)
        layers.append(Layer(sps[i], tables[i], codes, scale, p["w_base"],
                            atten, placement))
    return layers


def round_taps(layers: Sequence[Layer], dtype: torch.dtype) -> List[Layer]:
    """The layers with their taps rounded to ``dtype`` (a control: a
    contraction that keeps its taps in less than f32)."""
    return [dataclasses.replace(
        layer, table=layer.table.to(dtype).to(torch.float32))
        for layer in layers]


def _digital(layer: Layer, xb: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """float64 ``(E @ codes) * scale`` in blocks of rows; with the count of
    nonzero basis entries."""
    c = layer.codes.reshape(-1, layer.codes.shape[-1]).to(torch.float64)
    out, nnz = [], 0
    for s in range(0, xb.shape[0], _ROWS):
        e = asp.dense_basis(xb[s:s + _ROWS], layer.sp, layer.table)
        e = e.reshape(e.shape[0], -1)
        nnz += int((e != 0).sum())
        out.append(e.to(torch.float64) @ c)
    return torch.cat(out) * layer.scale.to(torch.float64), nnz


def _analog(layer: Layer, hw: Hardware, xb: torch.Tensor
            ) -> Tuple[torch.Tensor, int]:
    """The crossbar's or chip's readout times the ADC step and the scale,
    in float64; with the count of live (batch row, word line) pairs."""
    xbar = hw.xbar
    b = xb.shape[0]
    o = layer.codes.shape[-1]
    v = asp.dense_basis(xb, layer.sp, layer.table).reshape(b, -1)
    vq = crossbar.quantize_wl(v, xbar.input_bits)
    a_s = xbar.array_size
    if hw.kind == "crossbar":
        r = vq.shape[1]
        pad = -r % a_s
        va = torch.nn.functional.pad(vq * layer.atten, (0, pad))
        w = torch.nn.functional.pad(layer.codes.reshape(r, o), (0, 0, 0, pad))
        gain = None
    else:
        pl = layer.placement
        v_phys = torch.where(pl.valid, vq[:, pl.logical], 0.0)
        va = v_phys * crossbar.row_attenuation(v_phys.shape[1], xbar,
                                               xb.device)
        w, gain = pl.w, pl.gain
    live = int((va != 0).sum())
    total = crossbar.readout(va, w, gain, xbar)[:, :o]
    return (total.to(torch.float64) * xbar.lsb
            * layer.scale.to(torch.float64)), live


def forward(layers: Sequence[Layer], hw: Hardware, x: torch.Tensor
            ) -> Tuple[torch.Tensor, List[Dict[str, int]]]:
    """Scores [B, n_items] float64 for users ``x`` [B, n_items], and per
    layer the counts of the work its inputs need (``batch``, ``in``,
    ``basis``, ``out``, and ``nonzero_taps`` or ``live_pairs``)."""
    h = x.to(torch.float32)
    counts = []
    y = h
    for layer in layers:
        xb = asp.bound(h, layer.sp)
        i, s, o = layer.codes.shape
        count = {"batch": xb.shape[0], "in": i, "basis": s, "out": o}
        if hw.kind == "digital":
            y, count["nonzero_taps"] = _digital(layer, xb)
        else:
            y, count["live_pairs"] = _analog(layer, hw, xb)
        y = y + torch.relu(xb).to(torch.float64) @ layer.w_base.to(
            torch.float64)
        counts.append(count)
        h = y.to(torch.float32)
    return y, counts

"""The kernels' operation and byte counts: a hand count at a tiny shape, and
counts that come from the shapes and the inputs alone, the same however
the rows are placed or the products split."""
from __future__ import annotations

import inspect
import json

import pytest
import torch

from kbtiny import REPO
from kanbench import generator, peaks
from kanbench import run as bench
from kanbench.reference import cf_kan as ref_cf_kan
from kanbench.reference import asp
from kanbench.roofline import cim_mac, cim_mac_tiled, kan_fused


def test_kan_fused_hand_count():
    # 2 users x 3 inputs x 4 nonzero taps, 5 outputs: 24 taps x 5 outputs
    # multiply-adds, 10 scale multiplies; x, codes, scales and y once
    flops, n_bytes = kan_fused.count(2, 3, 10, 5, 24)
    assert flops == 2 * 24 * 5 + 2 * 5
    assert n_bytes == 4 * 2 * 3 + 3 * 10 * 5 + 4 * 5 + 4 * 2 * 5


@pytest.mark.parametrize("gains", [False, True])
def test_crossbar_hand_count(gains):
    # 7 live pairs x 3 columns x 8 planes multiply-adds; 2 users x 2 arrays
    # (5 rows of 4) x 3 columns x 8 planes ADC conversions
    flops, n_bytes = cim_mac_tiled.count(2, 5, 3, 7, 4, gains)
    assert flops == 2 * 7 * 3 * 8 + 2 * 2 * 3 * 8
    assert n_bytes == (4 * 2 * 5 + 5 * 3 + 4 * 5 + 4 * 2 * 3
                       + (4 * 5 * 3 if gains else 0))
    if not gains:
        assert cim_mac.count(2, 5, 3, 7, 4) == (flops, n_bytes)


def test_counts_take_shapes_and_input_counts_only():
    """No count has a parameter that says how a kernel computes."""
    allowed = {"batch", "n_in", "n_basis", "n_out", "nonzero_taps", "rows",
               "cols", "live_pairs", "array_size", "gains"}
    for fn in (kan_fused.count, cim_mac.count, cim_mac_tiled.count):
        assert set(inspect.signature(fn).parameters) <= allowed


def test_nonzero_taps_are_the_inputs_own():
    """The count of nonzero basis entries is the inputs': every input has
    K+1 nonzero taps in these configurations, so B * I * (K+1)."""
    sp = asp.Spline(grid_size=7, order=3, n_bits=8, coeff_bits=8)
    table = asp.tap_table(sp, "cpu")
    assert bool((table > 0).all())
    xb = asp.bound(torch.randn(5, 11), sp)
    assert int((asp.dense_basis(xb, sp, table) != 0).sum()) == 5 * 11 * 4


def test_live_pairs_do_not_depend_on_the_placement():
    """The chip's KAN-SAM placement and the monolithic crossbar order the
    rows differently; the live pairs they are counted from, for the same
    inputs of a layer, are the same. (The decoder's inputs through a whole
    forward are not: each substrate reads the encoder out differently.)"""
    assert _live("cim") == _live("cim_tiled")


def _live(backend):
    """Each layer's live pairs for the same weights and inputs: the users
    into the encoder, one hidden state into the decoder."""
    model = json.loads((REPO / "kanbench" / "configs"
                        / "cf-kan-1.json").read_text())
    model.update(n_items=256, hidden=16)
    traffic = {"cim": "chipeval.cim.b256",
               "cim_tiled": "chipeval.cim_tiled.b256"}[backend]
    t = json.loads((REPO / "kanbench" / "traffic"
                    / f"{traffic}.json").read_text())
    gen = torch.Generator().manual_seed(9)
    params = generator.make_params(model, gen)
    x = generator.make_pool(48, 256, gen)
    hw = bench.reference_hardware(t, 9)
    layers = ref_cf_kan.build(params, model, hw, [x[:16], x[16:32]])
    h = torch.randn((48, 16), generator=torch.Generator().manual_seed(1))
    return [ref_cf_kan._analog(layer, hw, asp.bound(inp, layer.sp))[1]
            for layer, inp in zip(layers, (x, h))]


def test_peaks_bound():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)

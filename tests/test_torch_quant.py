"""Port parity: ASP-KAN-HAQ quantisation and splines (repro_torch.core)
against the JAX reference (repro.core) on the same numpy inputs.

Integer outputs (input codes, PowerGap split, coefficient codes, bit slices,
WL-DAC levels) and the SH-LUT must match bit for bit; float bases allclose.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq, splines as js  # noqa: E402
from repro.hw import cim as jcim  # noqa: E402
from repro_torch.core import quant as tq, splines as tsp  # noqa: E402
from repro_torch.hw import cim as tcim  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

GRIDS = (5, 7, 16)
ORDERS = (2, 3)


def _cfgs(g, k):
    return jq.ASPConfig(grid_size=g, order=k), tq.ASPConfig(grid_size=g,
                                                             order=k)


def _x(seed, shape=(257, 33)):
    # a little beyond the knot range, so the clip at both ends is exercised
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.1, 1.1, shape).astype(np.float32)


@pytest.mark.parametrize("k", ORDERS)
@pytest.mark.parametrize("g", GRIDS)
def test_config_and_sh_lut_bitwise(g, k):
    a, b = _cfgs(g, k)
    for prop in ("ld", "levels_per_interval", "n_levels", "n_basis",
                 "n_taps", "step"):
        assert getattr(a, prop) == getattr(b, prop), prop
    hj = np.asarray(jq.hemi_for(a))
    ht = tq.hemi_for(b, "cpu")
    assert ht.dtype == torch.float32
    np.testing.assert_array_equal(ht.numpy(), hj)
    # made once per config and device: an equal config shares the table
    assert tq.hemi_for(dataclasses.replace(b), torch.device("cpu")) is ht


@pytest.mark.parametrize("k", ORDERS)
@pytest.mark.parametrize("g", GRIDS)
def test_input_codes_powergap_and_basis(g, k):
    a, b = _cfgs(g, k)
    x = _x(g * 10 + k)
    qj = jq.quantize_input(jnp.asarray(x), a)
    qt = tq.quantize_input(torch.from_numpy(x), b)
    assert qt.dtype == torch.int32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    segj, locj = jq.powergap_decode(qj, a)
    segt, loct = tq.powergap_decode(qt, b)
    np.testing.assert_array_equal(segt.numpy(), np.asarray(segj))
    np.testing.assert_array_equal(loct.numpy(), np.asarray(locj))

    hemi = np.array(jq.hemi_for(a))
    taps_j = jq.sh_lut_lookup(jnp.asarray(hemi), locj, a)
    taps_t = tq.sh_lut_lookup(torch.from_numpy(hemi), loct, b)
    np.testing.assert_array_equal(taps_t.numpy(), np.asarray(taps_j))
    basis_j = jq.quantized_basis(jnp.asarray(x), jnp.asarray(hemi), a)
    basis_t = tq.quantized_basis(torch.from_numpy(x), torch.from_numpy(hemi),
                                 b)
    np.testing.assert_allclose(basis_t.numpy(), np.asarray(basis_j),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("k", ORDERS)
@pytest.mark.parametrize("g", GRIDS)
def test_float_bases_allclose(g, k):
    x = _x(100 + g + k)
    ref = js.bspline_basis_uniform(jnp.asarray(x), -1.0, 1.0, g, k)
    got = tsp.bspline_basis_uniform(torch.from_numpy(x), -1.0, 1.0, g, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(tsp.make_knots(-1.0, 1.0, g, k),
                                  js.make_knots(-1.0, 1.0, g, k))


@pytest.mark.parametrize("k", ORDERS)
@pytest.mark.parametrize("g", GRIDS)
def test_coefficient_codes_and_bit_slices_bitwise(g, k):
    a, b = _cfgs(g, k)
    rng = np.random.default_rng(g * 7 + k)
    c = (rng.normal(size=(19, a.n_basis, 13)) * 0.3).astype(np.float32)
    codes_j, scale_j = jq.quantize_coeffs(jnp.asarray(c), a, axis=(0, 1))
    codes_t, scale_t = tq.quantize_coeffs(torch.from_numpy(c), b,
                                          axis=(0, 1))
    assert codes_t.dtype == torch.int8 and tuple(scale_t.shape) == (1, 1, 13)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))
    np.testing.assert_array_equal(
        tq.dequantize_coeffs(codes_t, scale_t).numpy(),
        np.asarray(jq.dequantize_coeffs(codes_j, scale_j)))
    sl_t = tq.bit_slices(codes_t)
    assert sl_t.dtype == torch.uint8
    np.testing.assert_array_equal(sl_t.numpy(),
                                  np.asarray(jq.bit_slices(codes_j)))


@pytest.mark.parametrize("coeff_bits", [8, 4, 2])
def test_sub8_bit_codes_bitwise(coeff_bits):
    a = jq.ASPConfig(grid_size=7, coeff_bits=coeff_bits)
    b = tq.ASPConfig(grid_size=7, coeff_bits=coeff_bits)
    c = np.random.default_rng(coeff_bits).normal(
        size=(11, a.n_basis, 6)).astype(np.float32)
    codes_j, scale_j = jq.quantize_coeffs(jnp.asarray(c), a, axis=(0, 1))
    codes_t, scale_t = tq.quantize_coeffs(torch.from_numpy(c), b,
                                          axis=(0, 1))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_wl_bitwise(bits):
    v = np.random.default_rng(bits).uniform(-0.1, 1.1, (64, 300)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcim.quantize_wl(torch.from_numpy(v), bits).numpy(),
        np.asarray(jcim.quantize_wl(jnp.asarray(v), bits)))


@pytest.mark.parametrize("array_size", [64, 128, 256, 1024])
@pytest.mark.parametrize("gamma0", [0.02, 0.08, 0.3])
def test_row_attenuation_bitwise(array_size, gamma0):
    cj = jcim.CIMConfig(array_size=array_size, gamma0=gamma0)
    ct = tcim.CIMConfig(array_size=array_size, gamma0=gamma0)
    np.testing.assert_array_equal(
        tcim.row_attenuation(3000, ct, "cpu").numpy(),
        np.asarray(jcim.row_attenuation(3000, cj)))

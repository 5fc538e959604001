"""Port parity for the hand-written kernels' plain versions, plus the
kernels themselves against those plain versions on the card.

* ``kan_spline_ref`` (the port's plain fused spline) against the JAX
  package's Pallas kernel ``ops.kan_spline_fused_deployed`` in interpret
  mode, at the JAX suite's bar ``atol=2e-5, rtol=1e-5``.
* ``cim_mac_ref`` against ``ops.cim_mac`` at the JAX bar ``atol=2e-3,
  rtol=1e-4``.
* ``cuda``-marked cases launch the CUDA kernels on the card and skip without
  one. They import no JAX, so they also run where JAX is not installed:
  ``python -m pytest -q -m cuda tests/test_torch_kernels.py``. Besides the
  small cases against the plain version, ``kan_fused`` runs at shapes that
  cross its k-block, output-tile and split edges and at CF-KAN-1's full
  encoder and decoder shapes. There it is held, at the same bar, to the
  plain version's formula evaluated in float64: at I*S = 163,840 slots two
  f32 summation orders (the plain version's own among them) already differ
  from the exact sum by up to about the bar itself.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import kan_fused as tkf  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

KAN_SHAPES = [(8, 8, 8), (37, 23, 50), (128, 64, 128), (5, 130, 3)]
# (G, K, (B, I, O)): every grid on every shape in cubic order, and the
# quadratic order on one shape (interpret mode is slow)
KAN_CASES = ([(g, 3, s) for g in (5, 8, 16, 64) for s in KAN_SHAPES]
             + [(g, 2, (37, 23, 50)) for g in (5, 8, 16, 64)])
CIM_SHAPES = [(9, 100, 17), (32, 256, 64)]
# (B, I, O) at CF-KAN-1's G=7, K=3: B in {1, 257} around the 128-row tile,
# I in {1, 16384} at O = 108 (one k-block; the split over the inputs), O in
# {1, 16384} at I = 108 (1-byte and 16-byte code copies; 128 column tiles)
KAN_EDGE_SHAPES = [(1, 16384, 108), (257, 16384, 108), (1, 1, 108),
                   (257, 1, 108), (1, 108, 1), (257, 108, 1),
                   (1, 108, 16384), (257, 108, 16384)]
CF_KAN_1_SHAPES = {"enc": (256, 16384, 108), "dec": (256, 108, 16384)}
# (G, K, n_bits) past cubic splines (K+1 = 5, 6 taps) and past 8-bit inputs
# (L = 512 levels per interval): the kernel sizes its tap table from these
WIDE_CONFIGS = [(7, 4, 8), (7, 5, 8), (1, 3, 9)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import quant as jq
    from repro.kernels import ops as jops
    return types.SimpleNamespace(jnp=jnp, quant=jq, ops=jops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _kan_inputs(g, k, shape, seed, n_bits=8):
    b, i, o = shape
    cfg = tq.ASPConfig(grid_size=g, order=k, n_bits=n_bits)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, i)).astype(np.float32)
    coeffs = (rng.normal(size=(i, cfg.n_basis, o)) * 0.3).astype(np.float32)
    codes, scale = tq.quantize_coeffs(torch.from_numpy(coeffs), cfg,
                                      axis=(0, 1))
    return cfg, x, codes, scale.reshape(-1)


def _cim_inputs(shape, array_size, seed):
    b, r, c = shape
    rng = np.random.default_rng(seed)
    v = rng.random((b, r), dtype=np.float32)
    w = rng.integers(-127, 128, (r, c)).astype(np.int8)
    att = (1.0 - 0.05 * (np.arange(r) % array_size) / array_size).astype(
        np.float32)
    return v, w, att


@pytest.mark.parametrize("g,k,shape", KAN_CASES)
def test_kan_spline_plain_matches_jax_kernel(jx, g, k, shape):
    cfg, x, codes, scale = _kan_inputs(g, k, shape, seed=sum(shape) + g + k)
    jcfg = jx.quant.ASPConfig(grid_size=g, order=k)
    want = jx.ops.kan_spline_fused_deployed(
        jx.jnp.asarray(x), jx.jnp.asarray(codes.numpy()),
        jx.jnp.asarray(scale.numpy()), jcfg)
    got = tref.kan_spline_ref(torch.from_numpy(x), codes, scale, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    # on the CPU the public wrapper is exactly the plain version
    wrapped = tops.kan_spline_fused_deployed(torch.from_numpy(x), codes,
                                             scale, cfg)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("g,k,n_bits", WIDE_CONFIGS)
def test_kan_spline_plain_matches_jax_kernel_wide_configs(jx, g, k, n_bits):
    """The plain version at the configs the kernel now also takes."""
    cfg, x, codes, scale = _kan_inputs(g, k, (37, 23, 50), seed=g + k,
                                       n_bits=n_bits)
    jcfg = jx.quant.ASPConfig(grid_size=g, order=k, n_bits=n_bits)
    want = jx.ops.kan_spline_fused_deployed(
        jx.jnp.asarray(x), jx.jnp.asarray(codes.numpy()),
        jx.jnp.asarray(scale.numpy()), jcfg)
    got = tref.kan_spline_ref(torch.from_numpy(x), codes, scale, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("g,k,n_bits,fits", [
    (7, 3, 8, True), (7, 4, 8, True), (7, 5, 8, True), (1, 3, 9, True),
    (1, 7, 9, True), (4, 3, 12, True), (64, 2, 8, True),
    (1, 3, 10, False), (1, 7, 10, False), (1, 3, 12, False)])
def test_kan_fused_supported_follows_shared_memory(g, k, n_bits, fits):
    """The kernel takes any config whose split tap table (L x (K+1)
    entries of 8 bytes) fits beside the rest of the block's shared memory."""
    cfg = tq.ASPConfig(grid_size=g, order=k, n_bits=n_bits)
    span_max = 63 // cfg.n_basis + 2      # inputs a 64-slot k-block touches
    assert tkf.smem_bytes(cfg) == (182_784 + 2 * 128 * span_max * 4
                                   + cfg.levels_per_interval * cfg.n_taps * 8)
    if (g, k, n_bits) == (7, 3, 8):       # CF-KAN-1
        assert tkf.smem_bytes(cfg) == 192_000
    assert tkf.supported(cfg) is fits
    assert fits == (tkf.smem_bytes(cfg) <= tkf.MAX_SMEM)


def test_kan_fused_names_the_shared_memory_limit():
    """A config past shared memory raises before anything is launched,
    with the limit in the message; the public wrapper serves it on the CPU
    through the plain version."""
    cfg, x, codes, scale = _kan_inputs(1, 3, (2, 3, 4), seed=0, n_bits=10)
    assert not tkf.supported(cfg)
    hemi = tq.hemi_for(cfg, "cpu")
    before = tkf.kan_fused.launches
    with pytest.raises(ValueError, match="shared memory.*232448"):
        tkf.kan_fused(torch.from_numpy(x), codes, scale, hemi, asp=cfg)
    assert tkf.kan_fused.launches == before
    got = tops.kan_spline_fused_deployed(torch.from_numpy(x), codes, scale,
                                         cfg)
    np.testing.assert_array_equal(
        got.numpy(), tref.kan_spline_ref(torch.from_numpy(x), codes, scale,
                                         cfg).numpy())


@pytest.mark.parametrize("array_size", [64, 128, 256])
@pytest.mark.parametrize("shape", CIM_SHAPES)
def test_cim_mac_plain_matches_jax_kernel(jx, array_size, shape):
    v, w, att = _cim_inputs(shape, array_size, seed=shape[1] + array_size)
    want = jx.ops.cim_mac(jx.jnp.asarray(v), jx.jnp.asarray(w),
                          jx.jnp.asarray(att), array_size=array_size,
                          adc_bits=8)
    got = tref.cim_mac_ref(torch.from_numpy(v), torch.from_numpy(w),
                           torch.from_numpy(att), array_size, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=1e-4)
    wrapped = tops.cim_mac(torch.from_numpy(v), torch.from_numpy(w),
                           torch.from_numpy(att), array_size=array_size)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_cim_mac_adc_quantization_visible():
    """Coarser ADC must increase error vs the ideal MAC (plain version)."""
    v, w, _ = _cim_inputs((16, 256, 32), 256, seed=0)
    vt, wt = torch.from_numpy(v), torch.from_numpy(w)
    ideal = tref.cim_mac_ideal(vt, wt)
    err = [float((tops.cim_mac(vt, wt, torch.ones(256), array_size=256,
                               adc_bits=bits, in_scale=0.2) - ideal
                  ).abs().mean()) for bits in (4, 6, 8)]
    assert err[0] > err[1] > err[2]


def test_wrappers_reject_bad_inputs():
    cfg, x, codes, scale = _kan_inputs(5, 3, (4, 6, 3), seed=0)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):
        tops.kan_spline_fused_deployed(xt, codes.to(torch.int32), scale, cfg)
    with pytest.raises(ValueError):
        tops.kan_spline_fused_deployed(xt[:, :5], codes, scale, cfg)
    with pytest.raises(ValueError):
        tops.kan_spline_fused_deployed(xt, codes.transpose(0, 2).contiguous()
                                       .transpose(0, 2), scale, cfg)
    v, w, att = _cim_inputs((3, 10, 4), 4, seed=0)
    with pytest.raises(ValueError):
        tops.cim_mac(torch.from_numpy(v), torch.from_numpy(w).t(),
                     torch.from_numpy(att), array_size=4)
    with pytest.raises(ValueError):
        tops.cim_mac(torch.from_numpy(v), torch.from_numpy(w),
                     torch.from_numpy(att[:9]), array_size=4)


# --- the CUDA kernels on the card -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("g,k,shape", KAN_CASES)
def test_kan_fused_kernel_matches_plain(cuda, g, k, shape):
    cfg, x, codes, scale = _kan_inputs(g, k, shape, seed=sum(shape) + g + k)
    xt, ct, st = (torch.from_numpy(x).to(cuda), codes.to(cuda),
                  scale.to(cuda))
    before = tops.launch_counts()["kan_fused"]
    got = tops.kan_spline_fused_deployed(xt, ct, st, cfg)
    torch.cuda.synchronize()
    assert tops.launch_counts()["kan_fused"] == before + 1
    want = tref.kan_spline_ref(xt, ct, st, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("array_size", [64, 128, 256])
@pytest.mark.parametrize("shape", CIM_SHAPES)
def test_cim_mac_kernel_matches_plain(cuda, array_size, shape):
    v, w, att = _cim_inputs(shape, array_size, seed=shape[1] + array_size)
    vt, wt, at = (torch.from_numpy(a).to(cuda) for a in (v, w, att))
    before = tops.launch_counts()["cim_mac"]
    got = tops.cim_mac(vt, wt, at, array_size=array_size)
    torch.cuda.synchronize()
    assert tops.launch_counts()["cim_mac"] == before + 1
    want = tref.cim_mac_ref(vt, wt, at, array_size, 8)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-3, rtol=1e-4)


def _kan_exact(x, codes, scale, cfg):
    """The plain version's formula in float64: E (f32, exact in f64) times
    the codes, times the scale."""
    e = tq.quantized_basis(x, tq.hemi_for(cfg, x.device), cfg)
    e = e.reshape(x.shape[0], -1).to(torch.float64)
    c = codes.to(torch.float64).reshape(e.shape[1], -1)
    return (e @ c) * scale.to(torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KAN_EDGE_SHAPES
                         + list(CF_KAN_1_SHAPES.values()),
                         ids=lambda s: "x".join(map(str, s)))
def test_kan_fused_kernel_edges_and_cf_kan_1(cuda, shape):
    cfg, x, codes, scale = _kan_inputs(7, 3, shape, seed=sum(shape))
    xt, ct, st = (torch.from_numpy(x).to(cuda), codes.to(cuda),
                  scale.to(cuda))
    before = tops.launch_counts()["kan_fused"]
    got = tops.kan_spline_fused_deployed(xt, ct, st, cfg)
    torch.cuda.synchronize()
    assert tops.launch_counts()["kan_fused"] == before + 1
    want = _kan_exact(xt, ct, st, cfg)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.cpu().numpy(), atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", sorted(CF_KAN_1_SHAPES))
def test_kan_fused_kernel_is_deterministic(cuda, layer):
    """No atomics: two launches on the same inputs are bitwise equal, with
    and without the split over the inputs (encoder / decoder)."""
    cfg, x, codes, scale = _kan_inputs(7, 3, CF_KAN_1_SHAPES[layer], seed=1)
    xt, ct, st = (torch.from_numpy(x).to(cuda), codes.to(cuda),
                  scale.to(cuda))
    first = tops.kan_spline_fused_deployed(xt, ct, st, cfg)
    second = tops.kan_spline_fused_deployed(xt, ct, st, cfg)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KAN_EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("g,k,n_bits", WIDE_CONFIGS)
def test_kan_fused_kernel_wide_configs(cuda, g, k, n_bits, shape):
    """K = 4 and 5 at G = 7, and L = 512 at G = 1, n_bits = 9, at the
    ragged shapes, against the plain formula in float64."""
    cfg, x, codes, scale = _kan_inputs(g, k, shape, seed=sum(shape) + k,
                                       n_bits=n_bits)
    xt, ct, st = (torch.from_numpy(x).to(cuda), codes.to(cuda),
                  scale.to(cuda))
    before = tops.launch_counts()["kan_fused"]
    got = tops.kan_spline_fused_deployed(xt, ct, st, cfg)
    torch.cuda.synchronize()
    assert tops.launch_counts()["kan_fused"] == before + 1
    want = _kan_exact(xt, ct, st, cfg)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.cpu().numpy(), atol=2e-5, rtol=1e-5)

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
* ``kan_basis`` (the crossbar backends' dense quantised basis): on the CPU
  the wrapper is ``quant.quantized_basis``, on ``meta`` a shape-only
  stand-in, and it refuses what the kernel does not take; the crossbar
  backends take their basis from it. On the card the kernel equals
  ``quant.quantized_basis`` bit for bit (``torch.equal``) at the crossbar
  cells' and the LM engine's shapes, on cell edges and knots, past both
  ends of the range, on the SH-LUT's reflection seam and at L = 1, and a
  crossbar layer in ``kan.apply`` launches it once.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kan as tk, quant as tq  # noqa: E402
from repro_torch.kernels import kan_fused as tkf  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401
import test_torch_stages as tst  # noqa: E402

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
# kan_basis, (G, K, LD cap): the crossbar cells' grids at their L (32 at
# G 7, 16 at G 15), the KAN-FFN LLM's G 8, L = 1 (LD 0, one hemi row), and
# orders 0 and 5
BASIS_CONFIGS = [(7, 3, None), (15, 3, None), (8, 3, None), (7, 3, 0),
                 (5, 0, None), (7, 5, None)]
# (rows, I, G): the crossbar cells' encoder and decoder inputs (CF-KAN-1 at
# G 7, CF-KAN-2 at G 15), the LM engine's cim_tiled tick at G 8, and I *
# (G+K) not a multiple of the kernel's 4-float stores (13 * 10, 101 * 18)
# the crossbar cells' encoder and decoder inputs; 2816 and 1024 wide at 16
# rows; the kan_llm engine tick's up and down inputs, [16, 256] and
# [16, 85]; ragged shapes
BASIS_CARD_SHAPES = [(256, 16384, 7), (256, 16384, 15), (256, 108, 7),
                     (256, 101, 15), (16, 2816, 8), (16, 1024, 8),
                     (16, 256, 8), (16, 85, 8),
                     (5, 13, 7), (3, 101, 15), (1, 1, 7)]


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


def _basis_cfg(g, k, ld_cap=None):
    cfg = tq.ASPConfig(grid_size=g, order=k, ld_cap=ld_cap)
    return cfg, tq.hemi_for(cfg, "cpu")


def _basis_edges(cfg):
    """x on every cell edge (a knot every L of them) and an ulp either side,
    mid-cell on both sides of the SH-LUT's reflection seam (local =
    ceil(L/2) - 1 and ceil(L/2)) in every segment, and past both ends of the
    range, out to +-inf. Checks that the seam's codes are among them."""
    edges = (cfg.x_min + np.arange(-2, cfg.n_levels + 3) * cfg.step
             ).astype(np.float32)
    L = cfg.levels_per_interval
    half = (L + 1) // 2
    locals_ = [loc for loc in (half - 1, half) if loc < L]
    seam = (cfg.x_min + np.array([s * L + loc + 0.5
                                  for s in range(cfg.grid_size)
                                  for loc in locals_]) * cfg.step
            ).astype(np.float32)
    beyond = np.array([-np.inf, -1e30, -3.0, -1.0, 1.0, 1.5, 1e30, np.inf],
                      dtype=np.float32)
    x = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                        np.nextafter(edges, np.float32(-np.inf)), seam,
                        beyond])
    local = tq.powergap_decode(tq.quantize_input(torch.from_numpy(seam), cfg),
                               cfg)[1]
    assert set(local.tolist()) == set(locals_)
    return torch.from_numpy(x)


def _basis_x(shape, seed):
    """Bounded inputs, as ``kan.bound_input`` gives the crossbar backends."""
    rng = np.random.default_rng(seed)
    return torch.tanh(torch.from_numpy(
        rng.normal(0.0, 1.5, shape).astype(np.float32)))


@pytest.mark.parametrize("shape", [(4, 13), (2, 3, 7), (1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("g,k,ld_cap", BASIS_CONFIGS)
def test_kan_basis_plain_is_quantized_basis(g, k, ld_cap, shape):
    """On the CPU the wrapper is the plain version, leading dims and all,
    on random inputs and on the edge values."""
    cfg, hemi = _basis_cfg(g, k, ld_cap)
    for x in (_basis_x(shape, seed=g + k), _basis_edges(cfg)):
        got = tops.kan_basis(x, hemi, cfg)
        assert got.shape == x.shape + (cfg.n_basis,)
        assert got.dtype == torch.float32
        assert torch.equal(got, tq.quantized_basis(x, hemi, cfg))


@pytest.mark.parametrize("shape", [(4, 13), (2, 3, 7), (0, 5)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("g", [7, 15])
def test_kan_basis_meta_stand_in(g, shape):
    cfg, hemi = _basis_cfg(g, 3)
    got = tops.kan_basis(torch.empty(shape, device="meta"),
                         hemi.to("meta"), cfg)
    assert got.device.type == "meta" and got.dtype == torch.float32
    assert got.shape == shape + (cfg.n_basis,)


@pytest.mark.parametrize("case", ["bf16", "f64", "hemi_f64", "strided",
                                  "hemi_strided", "devices", "hemi_shape",
                                  "scalar"])
def test_kan_basis_rejects_bad_inputs(case):
    cfg, hemi = _basis_cfg(7, 3)
    x = _basis_x((4, 6), seed=0)
    bad = {"bf16": (x.to(torch.bfloat16), hemi),
           "f64": (x.double(), hemi),
           "hemi_f64": (x, hemi.double()),
           "strided": (x.t(), hemi),
           "hemi_strided": (x, hemi.t().contiguous().t()),
           "devices": (x, hemi.to("meta")),
           "hemi_shape": (x, hemi[:-1]),
           "scalar": (x[0, 0], hemi)}[case]
    with pytest.raises(ValueError):
        tops.kan_basis(*bad, cfg)


@pytest.mark.parametrize("backend", ["cim", "cim_tiled"])
def test_crossbar_backends_take_the_basis_from_kan_basis(monkeypatch,
                                                         backend):
    """Each crossbar layer of ``kan.apply`` gets its word-line values from
    one ``ops.kan_basis`` call on its bounded input."""
    dep = tst._deployed(backend)
    calls = []
    real = tops.kan_basis

    def spy(x, hemi, asp):
        calls.append((x.shape, asp))
        return real(x, hemi, asp)
    monkeypatch.setattr(tops, "kan_basis", spy)
    x = tst._users(5)
    tk.apply(dep, x)
    spec = dep.spec
    assert calls == [((5, spec.dims[i]), spec.layer(i).asp)
                     for i in range(spec.n_layers)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,g", BASIS_CARD_SHAPES,
                         ids=lambda v: str(v))
def test_kan_basis_kernel_equals_plain(cuda, b, i, g):
    cfg, hemi = _basis_cfg(g, 3)
    x = _basis_x((b, i), seed=b + i + g).to(cuda)
    hemi = hemi.to(cuda)
    before = tops.launch_counts()["kan_basis"]
    got = tops.kan_basis(x, hemi, cfg)
    torch.cuda.synchronize()
    assert tops.launch_counts()["kan_basis"] == before + 1
    assert torch.equal(got, tq.quantized_basis(x, hemi, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("g,k,ld_cap", BASIS_CONFIGS)
def test_kan_basis_kernel_edges(cuda, g, k, ld_cap):
    """Knots, cell edges and an ulp either side, the reflection seam, and
    inputs past both ends (clamped), bit for bit; as one row and as rows
    of 3."""
    cfg, hemi = _basis_cfg(g, k, ld_cap)
    x = _basis_edges(cfg).to(cuda)
    hemi = hemi.to(cuda)
    n = x.numel() - x.numel() % 3
    for xs in (x.reshape(1, -1), x[:n].reshape(-1, 3)):
        got = tops.kan_basis(xs, hemi, cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, tq.quantized_basis(xs, hemi, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cim", "cim_tiled"])
def test_crossbar_apply_launches_kan_basis(cuda, monkeypatch, backend):
    """One launch a crossbar layer in ``kan.apply``, and the same output as
    the apply with the plain basis."""
    dep = tst._deployed(backend, cuda)
    x = tst._users(37, cuda)
    before = tops.launch_counts()["kan_basis"]
    got = tk.apply(dep, x)
    torch.cuda.synchronize()
    assert tops.launch_counts()["kan_basis"] == before + len(dep.layers)
    monkeypatch.setattr(tops, "kan_basis", tq.quantized_basis)
    assert torch.equal(got, tk.apply(dep, x))

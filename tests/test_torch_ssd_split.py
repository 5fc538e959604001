"""A CPU rehearsal of the ``ssd_scan`` kernel's arithmetic, which only runs
on the card.

* The split: each f32 operand goes to the tensor cores as big =
  tf32(a) and small = tf32(a - big) (``cvt.rna``: round to 10 mantissa
  bits, ties away from zero). big + small gives a back to 2^-21 relative,
  each piece has at most 11 significant bits, and a product of two pieces
  is exact in f32.
* The decomposition: ``ssd_scan.ssd_scan_mirror`` runs the kernel's four
  steps (scores, chunk states, state passing, chunk scan) with its
  roundings, and with ``split=True`` its three large products as 3xTF32 in
  f32 sums. It is held to the JAX package's sequential oracle
  ``repro.kernels.ref.ssd_ref`` and chunked ``repro.models.ssd.ssd_chunked``
  on the same numpy inputs, with an initial state and ragged T, at the bar
  the kernel is held to on the card: the JAX suite's ``atol 3e-5, rtol
  1e-4`` plus ``1e-6 * sum|terms|`` (the scan of |x|, |B|, |C|, |D| and
  |init|, as ``chip_smoke.py`` computes it), for y and the final state.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tscan  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

ATOL, RTOL, ORDER_REL = 3e-5, 1e-4, 1e-6
# (B, T, H, P, N), chunk: the JAX suite's shapes at its chunks, ragged T
# (37, 50) and T past a chunk, and mamba2-1.3b's P, N at its chunk 256
CASES = [((2, 37, 3, 8, 16), 8), ((2, 37, 3, 8, 16), 16),
         ((1, 64, 2, 16, 8), 8), ((1, 64, 2, 16, 8), 16),
         ((2, 50, 4, 16, 16), 16), ((1, 512, 2, 64, 128), 256),
         ((1, 300, 2, 64, 128), 256)]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.models import ssd as jssd
    return types.SimpleNamespace(jnp=jnp, ref=jref, ssd=jssd)


def _values(seed, n=1 << 16):
    """f32 values over a wide range of magnitudes and both signs."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * np.exp2(rng.integers(-60, 60, size=n))
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_to_2e21(seed):
    a = _values(seed)
    big, small = tscan.tf32_split(a)
    err = (a.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0 ** -21 * a.double().abs()).all())
    # a - big is exact in f32: small is the f32 residual, rounded once
    assert torch.equal((a - big).double(), a.double() - big.double())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_pieces_have_11_significant_bits(seed):
    a = _values(seed)
    for piece in tscan.tf32_split(a):
        bits = piece.view(torch.int32)
        assert bool(((bits & 0x1FFF) == 0).all())   # 13 low mantissa bits
    # rna: ties go away from zero, as cvt.rna.tf32.f32 rounds
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tscan.tf32_round(tie),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))
    # so a product of two pieces (11 x 11 bits) is exact in f32
    x, y = tscan.tf32_split(_values(seed + 7, 4096))[0], \
        tscan.tf32_split(_values(seed + 8, 4096))[0]
    assert torch.equal((x * y).double(), x.double() * y.double())


def _inputs(shape, seed):
    b, t, h, p, n = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(b, t, h, p)).astype(f),
        dt=np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(f),
        a=(-np.exp(rng.normal(size=h) * 0.3)).astype(f),
        b_mat=(rng.normal(size=(b, t, n)) * 0.3).astype(f),
        c_mat=(rng.normal(size=(b, t, n)) * 0.3).astype(f),
        d_skip=np.full(h, 0.5, f),
        init_state=rng.normal(size=(b, h, p, n)).astype(f) * 0.5)


def _worst(got, want, mass):
    """max |got - want| / (atol + rtol |want| + 1e-6 sum|terms|)."""
    want = torch.from_numpy(np.array(want, np.float32))
    tol = ATOL + RTOL * want.abs() + ORDER_REL * mass
    return float(((got - want).abs() / tol).max())


@pytest.mark.parametrize("split", [False, True], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("shape,chunk", CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_mirror_matches_jax(jx, shape, chunk, split):
    arr = _inputs(shape, seed=sum(shape) + chunk)
    ta = {k: torch.from_numpy(v) for k, v in arr.items()}
    ja = {k: jx.jnp.asarray(v) for k, v in arr.items()}
    args = ("x", "dt", "a", "b_mat", "c_mat", "d_skip")
    got_y, got_s = tscan.ssd_scan_mirror(
        *(ta[k] for k in args), chunk=chunk, init_state=ta["init_state"],
        split=split)
    assert got_y.shape == shape[:4] and got_s.shape == (shape[0], shape[2],
                                                         shape[3], shape[4])
    mass_y, mass_s = tref.ssd_chunked_ref(
        ta["x"].abs(), ta["dt"], ta["a"], ta["b_mat"].abs(),
        ta["c_mat"].abs(), ta["d_skip"].abs(), chunk=chunk,
        init_state=ta["init_state"].abs())
    seq_y, seq_s = jx.ref.ssd_ref(*(ja[k] for k in args), ja["init_state"])
    chk_y, chk_s = jx.ssd.ssd_chunked(*(ja[k] for k in args), chunk=chunk,
                                      init_state=ja["init_state"])
    for got, want, mass in ((got_y, seq_y, mass_y), (got_s, seq_s, mass_s),
                            (got_y, chk_y, mass_y), (got_s, chk_s, mass_s)):
        assert _worst(got, want, mass) <= 1.0


def test_mirror_f32_is_the_plain_chunked_form():
    """Without the split the mirror is the plain chunked form up to f32
    summation order."""
    arr = _inputs((2, 37, 3, 8, 16), seed=5)
    ta = {k: torch.from_numpy(v) for k, v in arr.items()}
    args = [ta[k] for k in ("x", "dt", "a", "b_mat", "c_mat", "d_skip")]
    got_y, got_s = tscan.ssd_scan_mirror(*args, chunk=8,
                                         init_state=ta["init_state"])
    want_y, want_s = tref.ssd_chunked_ref(*args, chunk=8,
                                          init_state=ta["init_state"])
    torch.testing.assert_close(got_y, want_y, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(got_s, want_s, atol=1e-6, rtol=1e-5)

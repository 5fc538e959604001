"""Port parity for the Mamba-2 SSD: the plain versions of the ``ssd_scan``
kernel and the SSD block against the JAX package, and the kernel against
its plain versions on the card.

* The bar of every f32 comparison is the JAX suite's ``atol=3e-5,
  rtol=1e-4`` (``tests/test_kernels.py``): the two packages differ only in
  the f32 summation order of their einsums and cumsums.
* JAX's ``ops.ssd`` runs its Pallas kernel in interpret mode on the CPU, as
  the JAX suite runs it.
* bf16 cases: the block's scan output is rounded to bf16 once (``y.astype
  (x.dtype)``); an f32 difference in the last bits can put that rounding on
  the other side of a bf16 step (2^-8 relative) in one package, so they are
  held to ``BF16_REL`` of the output's largest magnitude.
* The autograd Function's gradients against the sequential scan's
  (``ref.ssd_ref``, which shares no code with it) at mamba2-1.3b's layer
  shape: ``SEQ_GRAD_REL`` of each leaf's largest entry. The chunked form
  rounds each chunk's cumulative log-decay (up to 256 terms) in f32 and
  takes exps of its differences, so its VJP sits farther from the
  sequential one there than the suite's elementwise bar, which was set at
  chunks of 8-64.
* ``cuda``-marked cases launch the kernel on the card and skip without one.
  They import no JAX: ``python -m pytest -q -m cuda tests/test_torch_ssd.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tscan  # noqa: E402
from repro_torch.models import ssd as tssd  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

SEQ_GRAD_REL = 1e-4

ATOL, RTOL = 3e-5, 1e-4
BF16_REL = 2 ** -6          # four bf16 steps of the largest output
# the JAX suite's shapes (B, T, H, P, N) and chunks
SUITE_SHAPES = [(2, 37, 3, 8, 16), (1, 64, 2, 16, 8)]
SUITE_CHUNKS = [8, 16]


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops, ref as jref
    from repro.models import ssd as jssd
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref,
                                 ssd=jssd)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, seed, d_scale=0.5, init=False, dt_shift=0.0):
    """Scan inputs made with numpy: x, dt (> 0, post-softplus), a (< 0),
    B, C, d_skip and an optional initial state."""
    b, t, h, p, n = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    out = dict(
        x=rng.normal(size=(b, t, h, p)).astype(f),
        dt=np.log1p(np.exp(rng.normal(size=(b, t, h)) + dt_shift)).astype(f),
        a=(-np.exp(rng.normal(size=h) * 0.3)).astype(f),
        b_mat=(rng.normal(size=(b, t, n)) * 0.3).astype(f),
        c_mat=(rng.normal(size=(b, t, n)) * 0.3).astype(f),
        d_skip=np.full(h, d_scale, f))
    out["init_state"] = (rng.normal(size=(b, h, p, n)).astype(f) * 0.5
                         if init else None)
    return out


def _t(arrays, device="cpu"):
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in arrays.items()}


def _j(jx, arrays):
    return {k: None if v is None else jx.jnp.asarray(v)
            for k, v in arrays.items()}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# --- the kernel's plain versions against the JAX package -------------------

@pytest.mark.parametrize("chunk", SUITE_CHUNKS)
@pytest.mark.parametrize("shape", SUITE_SHAPES)
def test_ssd_ref_matches_jax_oracle(jx, shape, chunk):
    arr = _inputs(shape, seed=shape[1] + chunk, init=chunk == 16)
    ja, ta = _j(jx, arr), _t(arr)
    want_y, want_s = jx.ref.ssd_ref(ja["x"], ja["dt"], ja["a"], ja["b_mat"],
                                    ja["c_mat"], ja["d_skip"],
                                    ja["init_state"])
    got_y, got_s = tref.ssd_ref(ta["x"], ta["dt"], ta["a"], ta["b_mat"],
                                ta["c_mat"], ta["d_skip"], ta["init_state"])
    _close(got_y, want_y)
    _close(got_s, want_s)


@pytest.mark.parametrize("chunk", SUITE_CHUNKS)
@pytest.mark.parametrize("shape", SUITE_SHAPES)
def test_ops_ssd_matches_jax_kernel(jx, shape, chunk):
    """The port's public wrapper (on the CPU: the plain chunked form)
    against the JAX Pallas kernel in interpret mode, and against the JAX
    oracle, at the JAX suite's shapes."""
    arr = _inputs(shape, seed=shape[1] + chunk)
    ja, ta = _j(jx, arr), _t(arr)
    args = ("x", "dt", "a", "b_mat", "c_mat", "d_skip")
    want = jx.ops.ssd(*(ja[k] for k in args), chunk=chunk)
    oracle, _ = jx.ref.ssd_ref(*(ja[k] for k in args))
    got = tops.ssd(*(ta[k] for k in args), chunk=chunk)
    assert got.shape == shape[:4] and got.dtype == torch.float32
    _close(got, want)
    _close(got, oracle)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape,chunk", [((2, 37, 3, 8, 16), 8),
                                         ((1, 64, 2, 16, 8), 16),
                                         ((2, 50, 4, 16, 16), 16),
                                         ((1, 16, 2, 8, 16), 16)])
def test_ssd_chunked_matches_jax(jx, shape, chunk, init):
    """y and the final state, with and without an initial state, ragged T
    (37 and 50 are no chunk multiples) and T = one chunk."""
    arr = _inputs(shape, seed=7 * shape[1] + chunk, init=init)
    ja, ta = _j(jx, arr), _t(arr)
    args = ("x", "dt", "a", "b_mat", "c_mat", "d_skip")
    want_y, want_s = jx.ssd.ssd_chunked(*(ja[k] for k in args), chunk=chunk,
                                        init_state=ja["init_state"])
    got_y, got_s = tssd.ssd_chunked(*(ta[k] for k in args), chunk=chunk,
                                    init_state=ta["init_state"])
    _close(got_y, want_y)
    _close(got_s, want_s)
    # and the port's own chunked form against its sequential oracle
    ref_y, ref_s = tref.ssd_ref(*(ta[k] for k in args), ta["init_state"])
    _close(got_y, ref_y)
    _close(got_s, ref_s)


def test_ssd_chunked_without_skip_and_split_prompt():
    """No d_skip; and scanning T in two pieces, the second from the first's
    final state, equals one scan (what prefill + continued scans rely on)."""
    arr = _t(_inputs((2, 48, 2, 8, 16), seed=3))
    args = [arr[k] for k in ("x", "dt", "a", "b_mat", "c_mat")]
    y, s = tssd.ssd_chunked(*args, None, chunk=16)
    ref_y, ref_s = tref.ssd_ref(*args)
    _close(y, ref_y)
    _close(s, ref_s)
    first = [v[:, :20] if v.ndim > 1 else v for v in args]
    rest = [v[:, 20:] if v.ndim > 1 else v for v in args]
    y1, s1 = tssd.ssd_chunked(*first, None, chunk=16)
    y2, s2 = tssd.ssd_chunked(*rest, None, chunk=16, init_state=s1)
    _close(torch.cat([y1, y2], dim=1), y)
    _close(s2, s)


def test_ssd_chunked_masks_the_overflowing_decays():
    """With dt * |a| summed over a chunk far past 88, exp(cs_i - cs_j) for
    i < j is inf: the plain form must select it away (``where``), never
    multiply it by a zero mask (inf * 0 = NaN)."""
    arr = _t(_inputs((1, 64, 2, 8, 8), seed=5, dt_shift=4.0))
    args = [arr[k] for k in ("x", "dt", "a", "b_mat", "c_mat", "d_skip")]
    cs_span = float((arr["dt"][0, :64] * arr["a"]).sum(0).abs().max())
    assert cs_span > 200.0            # exp(+span) overflows f32
    y, s = tssd.ssd_chunked(*args, chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    ref_y, ref_s = tref.ssd_ref(*args)
    _close(y, ref_y)
    _close(s, ref_s)


def test_ssd_chunked_gradients_finite_past_the_overflow():
    """The plain form's VJP (what the card's autograd Function returns) on
    inputs whose masked decays overflow: every gradient finite, and equal
    to the sequential recurrence's at the suite's bar; the gradients of
    ``a`` and ``d_skip`` sum over every (t, p, n) of a head, in another
    order in each form, and are held at ``rtol 1e-3``."""
    arr = _t(_inputs((1, 64, 2, 8, 8), seed=5, dt_shift=4.0, init=True))
    names = ("x", "dt", "a", "b_mat", "c_mat", "d_skip", "init_state")
    leaves = {k: arr[k].double().float().requires_grad_() for k in names}
    args = [leaves[k] for k in names]
    rng = np.random.default_rng(6)
    dy = torch.from_numpy(rng.normal(size=(1, 64, 2, 8)).astype(np.float32))
    ds = torch.from_numpy(rng.normal(size=(1, 2, 8, 8)).astype(np.float32))
    y, s = tref.ssd_chunked_ref(*args[:6], chunk=64, init_state=args[6])
    got = torch.autograd.grad((y, s), args, (dy, ds))
    y_r, s_r = tref.ssd_ref(*args)
    want = torch.autograd.grad((y_r, s_r), args, (dy, ds))
    for name, g, w in zip(names, got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w.numpy(),
               rtol=1e-3 if name in ("a", "d_skip") else RTOL)


def test_ssd_decode_step_matches_jax(jx):
    rng = np.random.default_rng(11)
    b, h, p, n = 3, 4, 8, 16
    f = np.float32
    arr = dict(state=rng.normal(size=(b, h, p, n)).astype(f),
               x_t=rng.normal(size=(b, h, p)).astype(f),
               dt_t=np.abs(rng.normal(size=(b, h))).astype(f),
               a=(-np.exp(rng.normal(size=h) * 0.3)).astype(f),
               b_t=rng.normal(size=(b, n)).astype(f),
               c_t=rng.normal(size=(b, n)).astype(f),
               d_skip=np.full(h, 0.5, f))
    want = jx.ssd.ssd_decode_step(**_j(jx, arr))
    got = tssd.ssd_decode_step(**_t(arr))
    for g, w in zip(got, want):
        _close(g, w)
    # one decode step equals a one-step scan from the same state
    ta = _t(arr)
    y1, s1 = tref.ssd_ref(ta["x_t"][:, None], ta["dt_t"][:, None], ta["a"],
                          ta["b_t"][:, None], ta["c_t"][:, None],
                          ta["d_skip"], ta["state"])
    _close(got[0], y1[:, 0])
    _close(got[1], s1)


# --- the block ---------------------------------------------------------------

def _block(jx, dtype_name, seed=0):
    """A small SSD block initialised by JAX, carried across to the port."""
    jdt = {"f32": jx.jnp.float32, "bf16": jx.jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    jcfg = jx.ssd.SSDConfig(d_model=32, d_state=16, head_dim=16, chunk=16)
    tcfg = tssd.SSDConfig(d_model=32, d_state=16, head_dim=16, chunk=16)
    jp = jx.ssd.init_ssd_block(jx.jax.random.PRNGKey(seed), jcfg)
    # exercise nonzero a_log / dt_bias / d_skip (JAX initialises constants)
    rng = np.random.default_rng(seed)
    npp = {k: (v if isinstance(v, dict) else np.asarray(v))
           for k, v in jx.jax.tree.map(np.asarray, jp).items()}
    h = jcfg.n_heads
    npp["a_log"] = (rng.normal(size=h) * 0.3).astype(np.float32)
    npp["dt_bias"] = (rng.normal(size=h) * 0.5).astype(np.float32)
    npp["d_skip"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    npp["norm"] = {"scale": rng.uniform(0.5, 1.5, jcfg.d_inner
                                        ).astype(np.float32)}
    jp = jx.jax.tree.map(jx.jnp.asarray, npp)
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in npp.items()}
    x = rng.normal(size=(2, 37, 32)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x, jdt, tdt


def _bar(want, dtype_name):
    if dtype_name == "f32":
        return dict(atol=ATOL, rtol=RTOL)
    return dict(atol=BF16_REL * float(np.abs(np.asarray(
        want, np.float32)).max()), rtol=0)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_apply_ssd_block_matches_jax(jx, dtype_name):
    """bf16 input, f32 parameters: JAX promotes x @ in_proj to f32, and so
    must the port (the output is f32 in both)."""
    jcfg, tcfg, jp, tp, x, jdt, tdt = _block(jx, dtype_name)
    jxin = jx.jnp.asarray(x).astype(jdt)
    txin = torch.from_numpy(x).to(tdt)
    want = jx.ssd.apply_ssd_block(jp, jxin, jcfg)
    got = tssd.apply_ssd_block(tp, txin, tcfg)
    assert got.dtype == torch.float32 and want.dtype == jx.jnp.float32
    _close(got.numpy(), want, **_bar(want, dtype_name))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_apply_ssd_block_decode_matches_jax(jx, dtype_name):
    """Decode steps from a cache whose conv buffer is kept in the compute
    dtype (bf16 rounds the history, in both packages): outputs, state and
    buffer after each of 4 steps."""
    jcfg, tcfg, jp, tp, x, jdt, tdt = _block(jx, dtype_name, seed=1)
    jc = jx.ssd.init_ssd_cache(2, jcfg, jdt)
    tc = tssd.init_ssd_cache(2, tcfg, tdt)
    assert tc["conv_buf"].dtype == tdt
    for i in range(4):
        jy, jc = jx.ssd.apply_ssd_block_decode(
            jp, jx.jnp.asarray(x[:, i:i + 1]).astype(jdt), jc, jcfg)
        ty, tc = tssd.apply_ssd_block_decode(
            tp, torch.from_numpy(x[:, i:i + 1]).to(tdt), tc, tcfg)
        _close(ty.float().numpy(), jy, **_bar(jy, dtype_name))
        _close(tc["state"].numpy(), jc["state"], **_bar(jc["state"],
                                                        dtype_name))
        _close(tc["conv_buf"].float().numpy(),
               np.asarray(jc["conv_buf"], np.float32),
               **_bar(jc["conv_buf"], dtype_name))


def test_ssd_config_has_no_pallas_flag():
    """The device picks kernel or plain version; there is no flag."""
    fields = {f.name for f in tssd.SSDConfig.__dataclass_fields__.values()}
    assert "use_pallas" not in fields
    assert tssd.SSDConfig(d_model=2048).n_heads == 64


def test_kernel_shape_limits():
    """P in whole n8 tiles; the grid tiles P and N, so only the chunk's
    rows (its cs and dt in the chunk-scan block) bound shared memory."""
    assert tscan.supported(64, 128, 256)      # mamba2-1.3b
    assert tscan.supported(16, 16, 16) and tscan.supported(8, 16, 8)
    assert tscan.supported(256, 512, 256)     # P, N past one block's tile
    assert not tscan.supported(12, 16, 16)    # P not a multiple of 8
    assert not tscan.supported(64, 128, 32768)  # a chunk past shared memory
    assert tscan.supported(64, 128, 20992) and not tscan.supported(
        64, 128, 20993)
    # the chunk-scan block: three raw A tiles, two split B tiles, cs and dt
    assert tscan.smem_bytes(64, 128, 256) == (
        4 * (3 * 64 * 36 + 2 * 256) + 8 * 2 * 64 * 36)
    # scores [B, nc, cl, cl], chunk states [B, H, nc, P, N], cs, decays and
    # B split into {big, small} pairs
    assert tscan.workspace_floats(4, 2048, 64, 64, 128, 256) == (
        4 * 8 * 256 * 256 + 4 * 64 * 8 * 64 * 128 + 4 * 64 * 8 * 256
        + 4 * 64 * 8 + 2 * 4 * 2048 * 128)
    # rows and columns rounded up to 4 (16-byte copies), regions too
    assert tscan.workspace_floats(1, 37, 3, 8, 6, 10) == (
        4 * 10 * 12 + 3 * 4 * 8 * 8 + 120 + 12 + 2 * 37 * 8)


def test_wrapper_rejects_mixed_devices():
    arr = _t(_inputs((1, 8, 1, 8, 8), seed=0))
    with pytest.raises(ValueError):
        tops.ssd(arr["x"], arr["dt"], arr["a"].to("meta"), arr["b_mat"],
                 arr["c_mat"], arr["d_skip"], chunk=8)
    with pytest.raises(ValueError):
        tops.ssd(arr["x"], arr["dt"], arr["a"], arr["b_mat"], arr["c_mat"],
                 arr["d_skip"], chunk=0)


# --- the CUDA kernel on the card -------------------------------------------

def _kernel_vs_plain(dev, shape, chunk, *, seed, init=False, strided=False):
    arr = _t(_inputs(shape, seed=seed, init=init), dev)
    args = [arr[k] for k in ("x", "dt", "a", "b_mat", "c_mat", "d_skip")]
    if strided:   # x, B and C as views of one buffer, as the block gives them
        b, t, h, p, n = shape
        buf = torch.cat([args[0].reshape(b, t, h * p), args[3], args[4]], -1)
        args[0] = buf[..., :h * p].reshape(b, t, h, p)
        args[3], args[4] = buf[..., h * p:h * p + n], buf[..., h * p + n:]
        assert not args[3].is_contiguous()
    before = tscan.ssd_scan.launches
    got_y, got_s = tops.ssd_state(*args, chunk=chunk,
                                  init_state=arr["init_state"])
    torch.cuda.synchronize()
    assert tscan.ssd_scan.launches == before + 1
    want_y, want_s = tref.ssd_chunked_ref(*args, chunk=chunk,
                                          init_state=arr["init_state"])
    _close(got_y.cpu(), want_y.cpu())
    _close(got_s.cpu(), want_s.cpu())
    oracle_y, oracle_s = tref.ssd_ref(*args, arr["init_state"])
    _close(got_y.cpu(), oracle_y.cpu())
    _close(got_s.cpu(), oracle_s.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", SUITE_CHUNKS)
@pytest.mark.parametrize("shape", SUITE_SHAPES)
def test_ssd_kernel_matches_plain_suite_shapes(cuda, shape, chunk):
    _kernel_vs_plain(cuda, shape, chunk, seed=shape[1] + chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((2, 100, 3, 16, 16), 32),
                                         ((1, 300, 2, 8, 32), 256)])
def test_ssd_kernel_ragged_t_and_init_state(cuda, shape, chunk):
    _kernel_vs_plain(cuda, shape, chunk, seed=1, init=True)
    _kernel_vs_plain(cuda, shape, chunk, seed=2, init=False, strided=True)


@pytest.mark.cuda
def test_ssd_kernel_full_width_chunk(cuda):
    """mamba2-1.3b's P=64, N=128 at chunk 256 (fewer heads and steps)."""
    _kernel_vs_plain(cuda, (1, 512, 2, 64, 128), 256, seed=3, init=True,
                     strided=True)


@pytest.mark.cuda
def test_ssd_kernel_rejects_unsupported_shapes(cuda):
    arr = _t(_inputs((1, 16, 1, 12, 8), seed=0), cuda)
    args = [arr[k] for k in ("x", "dt", "a", "b_mat", "c_mat", "d_skip")]
    before = tscan.ssd_scan.launches
    with pytest.raises(ValueError, match="not supported"):
        tops.ssd(*args, chunk=8)
    assert tscan.ssd_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [8, 24, 100])
def test_ssd_kernel_chunks_off_the_mma_tile(cuda, chunk):
    """Chunks that are no multiple of the 32-deep k-block or the 64-row
    tile, at a T that is no multiple of the chunk."""
    _kernel_vs_plain(cuda, (2, 300, 3, 16, 32), chunk, seed=chunk,
                     init=True)
    _kernel_vs_plain(cuda, (1, 300, 2, 64, 128), chunk, seed=chunk + 1,
                     strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("p", [8, 16])
def test_ssd_kernel_fragment_edges(cuda, p, n):
    """P and N below one m16 / n8 fragment set: half-empty tiles."""
    _kernel_vs_plain(cuda, (2, 100, 3, p, n), 32, seed=p + n, init=True)


@pytest.mark.cuda
def test_ssd_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same inputs are bitwise equal."""
    arr = _t(_inputs((1, 512, 2, 64, 128), seed=4, init=True), cuda)
    args = [arr[k] for k in ("x", "dt", "a", "b_mat", "c_mat", "d_skip")]
    first = tops.ssd_state(*args, chunk=256, init_state=arr["init_state"])
    second = tops.ssd_state(*args, chunk=256, init_state=arr["init_state"])
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_ssd_function_gradients_match_plain_form(cuda):
    """The card's ``ssd_state`` under autograd (``ops._SsdScan``) at
    mamba2-1.3b's layer shape (B 2, T 2048, H 64, P 64, N 128, chunk 256):
    one ``ssd_scan`` launch forward, and every gradient (x, dt, a, B, C,
    d_skip, init_state) equal to the plain chunked form's VJP on the card
    at the suite's bar, and within ``SEQ_GRAD_REL`` of the sequential
    scan's. Without the Function the kernel's outputs carry no
    ``grad_fn`` and no input gets a gradient."""
    shape, chunk = (2, 2048, 64, 64, 128), 256
    arr = _t(_inputs(shape, seed=7, init=True), cuda)
    names = ("x", "dt", "a", "b_mat", "c_mat", "d_skip", "init_state")
    leaves = [arr[k].clone().requires_grad_() for k in names]
    gen = torch.Generator(device=cuda).manual_seed(8)
    dy = torch.randn(shape[:4], generator=gen, device=cuda)
    ds = torch.randn((2, 64, 64, 128), generator=gen, device=cuda)
    before = tscan.ssd_scan.launches
    y, s = tops.ssd_state(*leaves[:6], chunk=chunk, init_state=leaves[6])
    assert tscan.ssd_scan.launches == before + 1
    assert y.grad_fn is not None and s.grad_fn is not None
    got = torch.autograd.grad((y, s), leaves, (dy, ds))
    plain = [arr[k].clone().requires_grad_() for k in names]
    y_p, s_p = tref.ssd_chunked_ref(*plain[:6], chunk=chunk,
                                    init_state=plain[6])
    want = torch.autograd.grad((y_p, s_p), plain, (dy, ds))
    _close(y.detach().cpu(), y_p.detach().cpu())
    _close(s.detach().cpu(), s_p.detach().cpu())
    del y_p, s_p
    seq = [arr[k].clone().requires_grad_() for k in names]
    y_q, s_q = tref.ssd_ref(*seq)
    witness = torch.autograd.grad((y_q, s_q), seq, (dy, ds))
    del y_q, s_q
    for name, g, w, q in zip(names, got, want, witness):
        assert g is not None and bool(torch.isfinite(g).all()), name
        assert float(g.abs().max()) > 0, name
        _close(g.cpu(), w.cpu())
        err = float((g - q).abs().max()) / float(q.abs().max())
        assert err <= SEQ_GRAD_REL, (name, err)

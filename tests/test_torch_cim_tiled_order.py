"""The order of the ``cim_mac_tiled`` CUDA kernel, rehearsed on the CPU.

``csrc/cim_mac_tiled.cu`` cannot run without a card. ``kernel_order`` below
is a plain-torch copy of its arithmetic in its order:

* per group of ``GROUP`` batch rows and chunk of up to ``CHUNK`` rows of a
  tile, only the rows live for any of the group's batch rows
  (``fl(v * atten) != 0``), in row order, padded to whole ``AHEAD`` steps
  with rows of va = 0 (the three read from the kernel's source);
* the sign folded into the gain once per cell;
* one predicated add per set bit; planes 6 and 7 skipped where no column
  of the row's 32-column warp has them set; a plane the warp never met in
  a tile read as code 0;
* the row tiles split into parts, each part's codes summed in int32 and
  the parts added in reverse order;
* the ADC as rint(psum / lsb), which the kernel reads without a divide
  where its margin test passes (``adc_margin_rule`` below rehearses that).

It is held bit for bit to the port's plain version
(``ref.cim_mac_tiled_ref``) and to the JAX package's oracle
(``tiles.readout_codes(...).sum(-2)``) on sparse and dense inputs. This is
what makes skipping dead rows (a), folding the sign (b) and splitting the
row tiles (c) exact. On a card, the kernel's own count of the rows it
iterated is held to the copy's.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cf_kan_1 as tc1  # noqa: E402
from repro_torch.core import kan as tk, kan_sam as tsam  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.data import cf_synth  # noqa: E402
from repro_torch.hw import chip as tchip, cim as tcim  # noqa: E402
from repro_torch.hw import tiles as ttiles, variation as tvar  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import cim_mac as tcm, ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import cf_kan as tcf  # noqa: E402


def _kernel_blocking(names=("kGroup", "kChunk", "kAhead")):
    """The kernel's batch rows per block, rows per live-row list and rows
    loaded ahead, as its source states them."""
    text = (tbuild.CSRC / "cim_mac_tiled.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
                 for n in names)


GROUP, CHUNK, AHEAD = _kernel_blocking()
IN_SCALE = 0.2


@pytest.fixture(scope="module")
def jtiles():
    """The JAX package's tiles module, imported only here."""
    pytest.importorskip("jax")
    from repro.hw import tiles
    return tiles


def kernel_order(v, w, gain, atten, array_size, lsb, parts):
    """The kernel's arithmetic in the kernel's order. v [B, R] f32, w
    [R, C] int8, gain [R, C] f32 or None, atten [R]. Returns [B, C] int32
    and the (batch row, row) pairs whose terms it formed, padding rows
    included (what the kernel's ``rows_iterated`` counts)."""
    b, r = v.shape
    c = w.shape[1]
    n_tiles = r // array_size
    per = -(-n_tiles // parts)
    code = w.to(torch.int32)
    mag = code.abs()
    g = (torch.ones((r, c), dtype=torch.float32) if gain is None
         else gain.to(torch.float32))
    sg = torch.where(code < 0, -g, g)                         # (b)
    # the OR of each row's codes over its 32-column warp, per column
    cw = -(-c // 32) * 32
    warp_or = torch.nn.functional.pad(mag, (0, cw - c)).reshape(r, -1, 32)
    acc = torch.zeros_like(warp_or[:, :, 0])
    for lane in range(32):
        acc = acc | warp_or[:, :, lane]
    warp_or = acc.repeat_interleave(32, dim=1)[:, :c]          # [R, C]
    lsb_t = torch.full((), lsb, dtype=torch.float32)
    va_all = v.to(torch.float32) * atten.to(torch.float32)[None, :]
    out = torch.zeros((b, c), dtype=torch.int32)
    pairs = 0
    for b0 in range(0, b, GROUP):
        va = va_all[b0:b0 + GROUP]
        part_sums = []
        for p in range(parts):
            part = torch.zeros((va.shape[0], c), dtype=torch.int32)
            for t in range(p * per, min(n_tiles, (p + 1) * per)):
                ps = torch.zeros((8, va.shape[0], c), dtype=torch.float32)
                planes = torch.zeros((c,), dtype=torch.int32)
                t_end = (t + 1) * array_size
                for r0 in range(t * array_size, t_end, CHUNK):
                    rows = torch.arange(r0, min(r0 + CHUNK, t_end))
                    listed = rows[(va[:, rows] != 0).any(dim=0)].tolist()
                    pad = -len(listed) % AHEAD
                    pairs += (len(listed) + pad) * va.shape[0]
                    for row, live in ([(x, True) for x in listed]
                                      + [(r0, False)] * pad):
                        a = va[:, row] if live else torch.zeros(va.shape[0])
                        term = a[:, None] * sg[row][None, :]
                        orm = warp_or[row]
                        planes = planes | orm
                        for k in range(8):
                            on = ((mag[row] >> k) & 1).bool()
                            if k >= 6:
                                on = on & ((orm >> k) & 1).bool()
                            ps[k] = torch.where(on[None, :], ps[k] + term,
                                                ps[k])
                for k in range(8):
                    q = torch.round(ps[k] / lsb_t).to(torch.int32)
                    met = ((planes >> k) & 1).bool()[None, :]
                    part = part + (torch.where(met, q, 0) << k)
            part_sums.append(part)
        for part in reversed(part_sums):                      # (c)
            out[b0:b0 + GROUP] += part
    return out, pairs


def _tile(array_size, tile_cols=16, gamma0=0.15):
    return ttiles.TileConfig(array_size=array_size, tile_cols=tile_cols,
                             gamma0=gamma0, adc_in_scale=IN_SCALE)


def _check(jtiles, v, w, gain, tile, parts_list=(1, 2, 3)):
    """kernel_order at each split, the plain version and JAX's oracle:
    all bit for bit."""
    r = v.shape[1]
    att = ttiles.slot_attenuation(r, tile, "cpu")
    want = tref.cim_mac_tiled_ref(v, w, gain, att, tile.array_size,
                                  tile.adc_bits, tile.adc_in_scale)
    import jax.numpy as jnp
    jt = jtiles.TileConfig(**dataclasses.asdict(tile))
    oracle = np.asarray(jtiles.readout_codes(
        jnp.asarray(v.numpy()), jnp.asarray(w.numpy()), jt,
        gain=None if gain is None else jnp.asarray(gain.numpy())).sum(-2))
    np.testing.assert_array_equal(want.numpy(), oracle)
    n_tiles = r // tile.array_size
    for parts in sorted({min(p, n_tiles) for p in parts_list} | {n_tiles}):
        got, _ = kernel_order(v, w, gain, att, tile.array_size, tile.lsb,
                              parts)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"parts={parts}")
    return want


def _gain(r, c, tile, seed=5):
    tr, tc = ttiles.grid_shape(r, c, tile)
    return ttiles.unpack_image(tvar.grid_gain(
        tvar.VariationConfig(sigma=0.08, seed=seed), 0, tr, tc,
        tile.array_size, tile.tile_cols), tile)[:, :c].contiguous()


@pytest.mark.parametrize("with_gain", [True, False])
def test_order_at_suite_shape(jtiles, with_gain):
    """test_chip.py's bitwise shape: 9 x 96 by 96 x 20, As 32, dense v."""
    rng = np.random.default_rng(3)
    tile = _tile(32)
    v = torch.from_numpy(rng.random((9, 96), dtype=np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (96, 20)).astype(np.int8))
    gain = _gain(96, 20, tile) if with_gain else None
    _check(jtiles, v, w, gain, tile)


@pytest.fixture(scope="module")
def cf_inputs():
    """A narrow CF-KAN (128 items, hidden 16) from seed 0: each layer's
    quantised WL values on 40 synthetic users, its codes and its Phase-A
    criticality."""
    cfg = dataclasses.replace(tc1.SMOKE_MODEL, n_items=128, hidden=16,
                              backend="fused")
    ds = cf_synth.generate(n_users=104, n_items=128, seed=0)
    params = tcf.init(0, cfg, device="cpu")
    x = torch.from_numpy(ds.observed)
    stats = tcf.collect_layer_stats(params, [x[:32], x[32:64]], cfg)
    dep = tcf.deploy(params, cfg)
    enc, dec = dep.layers
    xe = tk.bound_input(x[64:], cfg.asp_enc)
    h = (tref.kan_spline_ref(xe, enc.codes, enc.scale.reshape(-1),
                             cfg.asp_enc, enc.hemi)
         + tk.base_branch(xe, enc.w_base, "relu"))
    xd = tk.bound_input(h, cfg.asp_dec)
    out = {}
    for name, xin, layer, asp in (("enc", xe, enc, cfg.asp_enc),
                                  ("dec", xd, dec, cfg.asp_dec)):
        wl = tcim.quantize_wl(tq.quantized_basis(xin, layer.hemi, asp)
                              .reshape(xin.shape[0], -1), 8)
        crit = tsam.criticality(stats[name], layer.codes).reshape(-1)
        out[name] = (wl, layer.codes, crit)
    return out


@pytest.mark.parametrize("layer", ["enc", "dec"])
@pytest.mark.parametrize("mapping", ["uniform", "sam"])
def test_order_on_cf_kan_wl_values(jtiles, cf_inputs, layer, mapping):
    """CF-KAN-shaped sparse inputs in the physical order that the cim_tiled
    deploy gives them (uniform or KAN-SAM placement, variation gains)."""
    wl, codes, crit = cf_inputs[layer]
    tile = _tile(64, tile_cols=64, gamma0=0.08)
    ccfg = tchip.ChipConfig(tile=tile, variation=tvar.VariationConfig(
        sigma=0.05, seed=0))
    tiled = tchip.place_layer(codes, crit if mapping == "sam" else None,
                              ccfg, layer_uid=0)
    v = torch.where(tiled.valid, wl[:, tiled.logical_of_phys.long()], 0.0)
    live = (v != 0).float().mean()
    assert 0.2 < float(live) < 0.6          # the inputs are sparse
    want = _check(jtiles, v, tiled.w_phys, tiled.gain, tile)
    assert bool((want != 0).any())
    _, pairs = kernel_order(v, tiled.w_phys, tiled.gain,
                            ttiles.slot_attenuation(v.shape[1], tile, "cpu"),
                            64, tile.lsb, 1)
    assert pairs < 0.75 * v.numel()


def _sparse(rng, b, r, density):
    v = rng.random((b, r), dtype=np.float32)
    v[rng.random((b, r)) >= density] = 0.0
    return v


def test_order_with_extreme_codes(jtiles):
    """Codes of +-127 and -128 (the only code with bit 7), sparse v."""
    rng = np.random.default_rng(11)
    tile = _tile(64)
    b, r, c = 21, 256, 40
    w = rng.integers(-128, 128, (r, c)).astype(np.int8)
    w[rng.random((r, c)) < 0.1] = -128
    w[rng.random((r, c)) < 0.1] = 127
    w[rng.random((r, c)) < 0.1] = -127
    v = torch.from_numpy(_sparse(rng, b, r, 0.4))
    w_t = torch.from_numpy(w)
    want = _check(jtiles, v, w_t, _gain(r, c, tile), tile)
    assert bool((want != 0).any())
    _check(jtiles, v, w_t, None, tile)


def test_order_with_a_dead_tile_and_lone_rows(jtiles):
    """One tile dead for every batch row (its codes are 0), and rows live
    for one batch row only."""
    rng = np.random.default_rng(12)
    tile = _tile(32)
    b, r, c = 37, 160, 33
    v = _sparse(rng, b, r, 0.3)
    v[:, 64:96] = 0.0                         # tile 2 dead
    lone = [5, 40, 100, 130, 159]
    v[:, lone] = 0.0
    for i, row in enumerate(lone):
        v[(7 * i + 3) % b, row] = 0.5 + 0.1 * i
    w = torch.from_numpy(rng.integers(-127, 128, (r, c)).astype(np.int8))
    v_t = torch.from_numpy(v)
    want = _check(jtiles, v_t, w, _gain(r, c, tile), tile,
                  parts_list=(1, 2, 4))
    # the dead tile's codes are 0 and the lone rows move their row alone
    att = ttiles.slot_attenuation(r, tile, "cpu")
    codes = tref.cim_mac_tiled_codes(v_t, w, None, att, 32, 8, IN_SCALE)
    assert not bool(codes[:, 2].any())
    _, pairs = kernel_order(v_t, w, None, att, 32, tile.lsb, 1)
    assert pairs < b * r and pairs >= sum(
        int((v_t[g:g + GROUP] != 0).any(0).sum()) * len(v_t[g:g + GROUP])
        for g in range(0, b, GROUP))
    assert want.shape == (b, c)


def _order_ties(n, lsb, rng):
    """n triples (x1, x2, x3) of f32 values in [0, 1) whose sum reads
    another ADC code when added in row order, ((x1 + x2) + x3), than when
    added in reverse, ((x3 + x2) + x1): their exact sum lies within an ulp
    of a .5 LSB boundary."""
    f = np.float32
    out = []
    while len(out) < n:
        x1, x2 = f(rng.random()), f(rng.random())
        t = (rng.integers(2, 5) + 0.5) * float(lsb) - float(x1) - float(x2)
        if not 0.0 < t < 1.0:
            continue
        for x3 in (np.nextafter(f(t), f(2.0)), f(t),
                   np.nextafter(f(t), f(0.0))):
            if np.rint((x1 + x2 + x3) / lsb) != np.rint((x3 + x2 + x1) / lsb):
                out.append((x1, x2, x3))
                break
    return np.array(out, dtype=np.float32)


def _tie_inputs():
    """As 512 and two lists per tile. Each batch row has three live rows in
    tile 0 whose values read another code if summed in another order: rows
    10, 100 and 200 (one list) for the first half of the batch, 100, 200
    and 300 (across both lists) for the second; tile 1 is sparse random.
    Returns v, w, the tile and the two halves' (first, last) rows."""
    rng = np.random.default_rng(13)
    tile = _tile(512, gamma0=0.0)               # atten = 1: va = v
    b, r, c = 20, 1024, 40
    v = _sparse(rng, b, r, 0.3)
    v[:, :512] = 0.0
    ties = _order_ties(b, np.float32(tile.lsb), rng)
    half = b // 2
    v[:half, [10, 100, 200]] = ties[:half]
    v[half:, [100, 200, 300]] = ties[half:]
    w = rng.integers(-127, 128, (r, c)).astype(np.int8)
    w[[10, 100, 200, 300]] = 1
    halves = ((10, 200, slice(0, half)), (100, 300, slice(half, b)))
    return torch.from_numpy(v), torch.from_numpy(w), tile, halves


def test_order_across_chunks_where_order_matters(jtiles):
    """Only the row order gives the plain version's codes on
    ``_tie_inputs``, across the two lists of a tile too. JAX's einsum sums
    in its own order and is held by whole ADC steps, as in
    test_torch_chip.py."""
    v, w, tile, halves = _tie_inputs()
    r = v.shape[1]
    att = ttiles.slot_attenuation(r, tile, "cpu")
    want = tref.cim_mac_tiled_ref(v, w, None, att, 512, 8, IN_SCALE)
    for first, last, rows in halves:
        swap = torch.arange(r)
        swap[[first, last]] = swap[[last, first]]
        reordered = tref.cim_mac_tiled_ref(v[:, swap], w[swap], None, att,
                                           512, 8, IN_SCALE)
        assert bool((reordered != want)[rows].all())
    for parts in (1, 2):
        got, _ = kernel_order(v, w, None, att, 512, tile.lsb, parts)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"parts={parts}")
    import jax.numpy as jnp
    oracle = np.asarray(jtiles.readout_codes(
        jnp.asarray(v.numpy()), jnp.asarray(w.numpy()),
        jtiles.TileConfig(**dataclasses.asdict(tile))).sum(-2))
    d = np.abs(want.numpy().astype(np.int64) - oracle)
    assert bool(np.all((d == 0) | (d == 1)))


def test_iterated_share_counts_groups_chunks_and_padding():
    """kernel_order's count on a hand-counted case: one group of three
    batch rows, As 256 in one chunk, rows 0, 1 and 300 live (each tile's
    list padded to 4 rows)."""
    w = torch.ones((512, 3), dtype=torch.int8)
    att = torch.ones(512)
    v = torch.zeros((3, 512))
    v[0, 0] = v[2, 1] = v[1, 300] = 1.0
    assert kernel_order(v, w, None, att, 256, 0.01, 1)[1] == (4 + 4) * 3
    # a group with no live row forms no term; the next, of one batch row,
    # forms its padded list's
    v2 = torch.zeros((GROUP + 1, 512))
    v2[GROUP, 7] = 1.0
    assert kernel_order(v2, w, None, att, 256, 0.01, 2)[1] == 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_on_order_ties(cuda):
    """The CUDA kernel on ``_tie_inputs``: the plain version's codes (on
    the card and on the CPU), twice."""
    v, w, tile, _ = _tie_inputs()
    att = ttiles.slot_attenuation(v.shape[1], tile, "cpu")
    want = tref.cim_mac_tiled_ref(v, w, None, att, 512, 8, IN_SCALE)
    v_c, w_c, att_c = v.to(cuda), w.to(cuda), att.to(cuda)
    kw = dict(array_size=512, adc_bits=8, in_scale=IN_SCALE)
    got = tops.cim_mac_tiled(v_c, w_c, att_c, **kw)
    again = tops.cim_mac_tiled(v_c, w_c, att_c, **kw)
    on_card = tref.cim_mac_tiled_ref(v_c, w_c, None, att_c, 512, 8, IN_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(on_card.cpu(), want)
    assert torch.equal(again, got)


def _counting_inputs(case):
    """Inputs for the count check: a dead tile with lone rows (As 32), or
    sparse rows over two 256-row lists of a tile (As 512) with a batch
    that is not a whole number of groups."""
    rng = np.random.default_rng(14)
    if case == "dead_tile":
        b, r, c, array_size = 37, 160, 33, 32
        v = _sparse(rng, b, r, 0.05)
        v[:, 64:96] = 0.0
        v[:, 5] = 0.0
        v[3, 5] = 0.5
    else:
        b, r, c, array_size = GROUP + 3, 1024, 40, 512
        v = _sparse(rng, b, r, 0.02)
    w = torch.from_numpy(rng.integers(-127, 128, (r, c)).astype(np.int8))
    return torch.from_numpy(v), w, array_size


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dead_tile", "two_lists"])
def test_kernel_counts_the_rows_of_its_order(cuda, case):
    """The kernel's ``rows_iterated`` count equals kernel_order's, and its
    codes the plain version's: the copy walks the rows the kernel walks."""
    v, w, array_size = _counting_inputs(case)
    tile = _tile(array_size)
    att = ttiles.slot_attenuation(v.shape[1], tile, "cpu")
    want, pairs = kernel_order(v, w, None, att, array_size, tile.lsb, 1)
    counter = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = tcm.cim_mac_tiled(v.to(cuda), w.to(cuda), None, att.to(cuda),
                            array_size=array_size, lsb=tile.lsb,
                            rows_iterated=counter)
    assert int(counter) == pairs < v.numel()
    assert torch.equal(got.cpu(), want)


def adc_margin_rule(a, lsb):
    """The kernel's ``adc_code`` in numpy f32: (code, clear) with code =
    rint(a * RN(1/lsb)), which it uses only where ``clear``."""
    f = np.float32
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        q = a * (f(1.0) / lsb)
        n = np.rint(q)
        to_half = np.abs(np.abs(q - n) - f(0.5))
        clear = ((f(2.0 ** -120) <= lsb) & (lsb <= f(2.0 ** 120))
                 & (np.abs(q) < f(2.0 ** 22))
                 & (to_half > np.abs(q) * f(2.0 ** -20)))
    return np.where(clear, n, 0).astype(np.int64), clear


@pytest.mark.parametrize("array_size", [32, 256, 1024])
def test_adc_margin_rule_is_division(array_size):
    """Where the divide-free readout is clear, its code is rint of the
    correctly rounded quotient, on values one ulp around .5 steps and on
    random psums of every magnitude; around the .5 steps it is not clear."""
    rng = np.random.default_rng(array_size)
    for in_scale in (1.2e-37, 1e-6, 0.2, 1.0, 7.3, 1e7, 2e37):
        lsb = np.float32(array_size * in_scale / 255.0)
        near = _half_step_values(lsb, rng)
        spread = (rng.random(200_000) * 2.0 ** rng.integers(-40, 24, 200_000)
                  * float(lsb))
        spread = spread[spread < 3e38].astype(np.float32)
        in_range = 2.0 ** -120 <= lsb <= 2.0 ** 120
        for a, share in ((near, 0.25), (-near, 0.25),
                         (spread, 0.9)):
            code, clear = adc_margin_rule(a, lsb)
            with np.errstate(over="ignore"):
                exact = np.rint(a / lsb)
            assert np.array_equal(code[clear], exact[clear].astype(np.int64))
            assert clear.mean() > share if in_range else not clear.any()
        if 7.5 * float(lsb) < 3e38 and in_range:
            half = np.float32(7.5 * float(lsb))
            ties = np.array([np.nextafter(half, np.float32(0)), half,
                             np.nextafter(half, np.float32(np.inf))])
            assert not adc_margin_rule(ties, lsb)[1].any()


def _half_step_values(lsb, rng):
    """Finite f32 values at, and one ulp either side of, (k + 0.5) * lsb
    and k * lsb for k from 0 to 2^23 - 2 (|q| >= 2^22 included), and
    values of 1e-30 and less (q underflows at some LSBs)."""
    f = np.float32
    ks = [0, 1, 2, 3, 7, 100, 127, 255, 1000, 65535, 2 ** 21 + 1,
          2 ** 22 - 1, 2 ** 22, 2 ** 22 + 3, 2 ** 23 - 2]
    ks += [int(k) for k in rng.integers(0, 2 ** 16, 8)]
    out = [x for x in (f(1e-30), f(3e-39), f(1e-45))
           if x / float(lsb) < 2 ** 22]
    for k in ks:
        for x in ((k + 0.5) * float(lsb), k * float(lsb)):
            if 0.0 < x < 3e38:
                x = f(x)
                out += [np.nextafter(x, f(0.0)), x,
                        np.nextafter(x, f(np.inf))]
    return np.array([x for x in out if x > 0], dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("array_size", [32, 64, 128, 256, 512, 1024])
def test_kernel_adc_at_half_steps(cuda, array_size):
    """The ADC alone: one live row per output, ideal cells and atten 1, so
    each psum is the value itself; values one ulp around .5 LSB steps (the
    kernel's divide-free readout must hand these to __fdiv_rn), codes of
    2^22 and more, LSBs inside and outside [2^-120, 2^120], codes of 1, -1
    and -128. Bitwise the plain version on the card."""
    rng = np.random.default_rng(array_size)
    r = 2 * array_size
    w = torch.tensor([[1, -1, -128]], dtype=torch.int8).repeat(r, 1)
    att = torch.ones(r, device=cuda)
    large = []
    for in_scale in (1.2e-37, 1e-6, 0.2, 1.0, 7.3, 1e7, 2e37):
        lsb = np.float32(array_size * in_scale / 255.0)
        vals = _half_step_values(lsb, rng)
        v = np.zeros((len(vals), r), dtype=np.float32)
        rows = np.arange(len(vals))
        v[rows, (rows * 37) % r] = vals        # one row, in either tile
        v_c, w_c = torch.from_numpy(v).to(cuda), w.to(cuda)
        got = tops.cim_mac_tiled(v_c, w_c, att, array_size=array_size,
                                 adc_bits=8, in_scale=in_scale)
        want = tref.cim_mac_tiled_ref(v_c, w_c, None, att, array_size, 8,
                                      in_scale)
        large.append(bool((want[:, 0] >= 2 ** 22).any()))
        assert torch.equal(got, want), f"in_scale={in_scale}"
    assert any(large)

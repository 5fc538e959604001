"""The order of the crossbar MAC CUDA kernels, rehearsed on the CPU.

``csrc/cim_mac_tiled.cu`` and ``csrc/cim_mac.cu`` are two instantiations
of one kernel body (``csrc/cim_mac_common.cuh``) and cannot run without a
card. ``walk_array`` below is a plain-torch copy of that body's
arithmetic in its order, for one array of one group of batch rows:

* per group of ``GROUP`` batch rows and chunk of up to ``CHUNK`` rows of an
  array, only the rows live for any of the group's batch rows
  (``fl(v * atten) != 0``), in row order, padded to whole ``AHEAD`` steps
  with rows of va = 0 (the blocking read from the kernel's source); a
  ragged last array stops at R;
* the sign folded into the gain once per cell;
* one predicated add per set bit; planes 6 and 7 skipped where no column
  of the row's 32-column warp has them set; a plane the warp never met in
  an array read as 0;
* the ADC as rint(psum / lsb), which the kernel reads without a divide
  where its margin test passes (``adc_margin_rule`` below rehearses that).

``kernel_order`` (``cim_mac_tiled``) sums each array's int32 codes over
parts of the arrays, the parts added in reverse order. ``readout_order``
(``cim_mac``) sums each array's f32 readouts ``2^k * fl(n_k * lsb)`` over
the planes in order, and ``sum_over_arrays`` adds the arrays of each part
in order and the parts in part order, split as the launcher splits them
(``launch_split``).

They are held bit for bit to the port's plain versions
(``ref.cim_mac_tiled_ref``; ``ref.cim_mac_ref``'s readouts, read off one
array and one bit plane at a time) and to the JAX package's oracles
(``tiles.readout_codes(...).sum(-2)``; ``ops.cim_mac`` in interpret mode
at the JAX suite's bar) on sparse and dense inputs. This is what makes
skipping dead rows (a), folding the sign (b) and splitting the arrays
(c, d) exact. On a card, each kernel's own count of the rows it iterated
is held to the copy's, and ``cim_mac``'s output to its copy's bit for bit.
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
from test_torch_attention import _one_torch_thread  # noqa: E402,F401


def _kernel_blocking(names=("kGroup", "kChunk", "kAhead", "kColWarps",
                            "kBlocksPerSm")):
    """The kernels' batch rows per block, rows per live-row list, rows
    loaded ahead, 32-column warps per block and blocks per SM aimed at when
    the arrays are split, as their shared source states them."""
    text = (tbuild.CSRC / "cim_mac_common.cuh").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
                 for n in names)


GROUP, CHUNK, AHEAD, COL_WARPS, BLOCKS_PER_SM = _kernel_blocking()
IN_SCALE = 0.2
H100_SMS = 132


@pytest.fixture(scope="module")
def jtiles():
    """The JAX package's tiles module, imported only here."""
    pytest.importorskip("jax")
    from repro.hw import tiles
    return tiles


def _warp_or(mag):
    """The OR of each row's code magnitudes over its 32-column warp, per
    column: [R, C]."""
    r, c = mag.shape
    cw = -(-c // 32) * 32
    lanes = torch.nn.functional.pad(mag, (0, cw - c)).reshape(r, -1, 32)
    acc = torch.zeros_like(lanes[:, :, 0])
    for lane in range(32):
        acc = acc | lanes[:, :, lane]
    return acc.repeat_interleave(32, dim=1)[:, :c]


def walk_array(va, sg, mag, warp_or, r_begin, r_end):
    """One array (rows r_begin..r_end, r_end at most R) of one batch group
    in the kernel's order. va: the group's [g, R] fl(v * atten); sg: [R, C]
    sign folded into the gain; mag: [R, C] code magnitudes. Returns the
    eight planes' psums [8, g, C], the planes met [C] (bit k for plane k)
    and the (batch row, row) pairs whose terms it formed."""
    g, c = va.shape[0], sg.shape[1]
    ps = torch.zeros((8, g, c), dtype=torch.float32)
    planes = torch.zeros((c,), dtype=torch.int32)
    n_rows = 0
    for r0 in range(r_begin, r_end, CHUNK):
        rows = torch.arange(r0, min(r0 + CHUNK, r_end))
        listed = rows[(va[:, rows] != 0).any(dim=0)].tolist()
        pad = -len(listed) % AHEAD
        n_rows += len(listed) + pad
        for row, live in [(x, True) for x in listed] + [(r0, False)] * pad:
            a = va[:, row] if live else torch.zeros(g)
            term = a[:, None] * sg[row][None, :]
            orm = warp_or[row]
            planes = planes | orm
            for k in range(8):
                on = ((mag[row] >> k) & 1).bool()
                if k >= 6:
                    on = on & ((orm >> k) & 1).bool()
                ps[k] = torch.where(on[None, :], ps[k] + term, ps[k])
    return ps, planes, n_rows * g


def _walk_inputs(v, w, gain, atten):
    code = w.to(torch.int32)
    mag = code.abs()
    g = (torch.ones(code.shape, dtype=torch.float32) if gain is None
         else gain.to(torch.float32))
    sg = torch.where(code < 0, -g, g)                         # (b)
    va = v.to(torch.float32) * atten.to(torch.float32)[None, :]
    return va, sg, mag, _warp_or(mag)


def kernel_order(v, w, gain, atten, array_size, lsb, parts):
    """``cim_mac_tiled``'s arithmetic in the kernel's order. v [B, R] f32,
    w [R, C] int8, gain [R, C] f32 or None, atten [R]. Returns [B, C] int32
    and the (batch row, row) pairs whose terms it formed, padding rows
    included (what the kernel's ``rows_iterated`` counts)."""
    b, r = v.shape
    c = w.shape[1]
    n_tiles = -(-r // array_size)
    per = -(-n_tiles // parts)
    va_all, sg, mag, warp_or = _walk_inputs(v, w, gain, atten)
    lsb_t = torch.full((), lsb, dtype=torch.float32)
    out = torch.zeros((b, c), dtype=torch.int32)
    pairs = 0
    for b0 in range(0, b, GROUP):
        va = va_all[b0:b0 + GROUP]
        part_sums = []
        for p in range(parts):
            part = torch.zeros((va.shape[0], c), dtype=torch.int32)
            for t in range(p * per, min(n_tiles, (p + 1) * per)):
                ps, planes, n = walk_array(va, sg, mag, warp_or,
                                           t * array_size,
                                           min(r, (t + 1) * array_size))
                pairs += n
                for k in range(8):
                    q = torch.round(ps[k] / lsb_t).to(torch.int32)
                    met = ((planes >> k) & 1).bool()[None, :]
                    part = part + (torch.where(met, q, 0) << k)
            part_sums.append(part)
        for part in reversed(part_sums):                      # (c)
            out[b0:b0 + GROUP] += part
    return out, pairs


def readout_order(v, w, atten, array_size, lsb):
    """``cim_mac``'s arithmetic per array in the kernel's order (ideal
    cells). Returns the readouts fl(n_k * lsb) [8, B, T, C] of the T
    arrays, each array's sum over the planes its warp met of
    fl(2^k * readout_k) in plane order [B, T, C], and the (batch row, row)
    pairs whose terms it formed."""
    b, r = v.shape
    c = w.shape[1]
    n_arrays = -(-r // array_size)
    va_all, sg, mag, warp_or = _walk_inputs(v, w, None, atten)
    lsb_t = torch.full((), lsb, dtype=torch.float32)
    readouts = torch.zeros((8, b, n_arrays, c), dtype=torch.float32)
    sums = torch.zeros((b, n_arrays, c), dtype=torch.float32)
    pairs = 0
    for b0 in range(0, b, GROUP):
        va = va_all[b0:b0 + GROUP]
        for t in range(n_arrays):
            ps, planes, n = walk_array(va, sg, mag, warp_or, t * array_size,
                                       min(r, (t + 1) * array_size))
            pairs += n
            s = torch.zeros((va.shape[0], c), dtype=torch.float32)
            for k in range(8):
                readout = torch.round(ps[k] / lsb_t) * lsb_t
                readouts[k, b0:b0 + GROUP, t] = readout
                met = ((planes >> k) & 1).bool()[None, :]
                s = torch.where(met, s + (2.0 ** k) * readout, s)
            sums[b0:b0 + GROUP, t] = s
    return readouts, sums, pairs


def launch_split(b, r, c, array_size, n_sm=H100_SMS):
    """The launcher's split of the arrays: (parts, arrays per part), at
    about BLOCKS_PER_SM blocks per SM."""
    blocks = -(-b // GROUP) * -(-c // (32 * COL_WARPS))
    n_arrays = -(-r // array_size)
    parts = max(1, min(n_arrays, -(-BLOCKS_PER_SM * n_sm // blocks)))
    per = -(-n_arrays // parts)
    return (-(-n_arrays // per) if n_arrays else 1), per


def sum_over_arrays(sums, parts):
    """``cim_mac``'s output from each array's sum [B, T, C]: the arrays of
    each of ``parts`` parts added in order, then the parts in part order
    (the launcher's second kernel), or the one part's sum as it is."""
    n_arrays = sums.shape[1]
    per = -(-n_arrays // parts)
    part_sums = []
    for p in range(-(-n_arrays // per)):
        acc = torch.zeros_like(sums[:, 0])
        for t in range(p * per, min(n_arrays, (p + 1) * per)):
            acc = acc + sums[:, t]
        part_sums.append(acc)
    if len(part_sums) == 1:
        return part_sums[0]
    out = torch.zeros_like(sums[:, 0])
    for acc in part_sums:                                     # (d)
        out = out + acc
    return out


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


# --- cim_mac: f32 readouts, a ragged last array ------------------------------

DEC_ROWS = 1080           # CF-KAN-1's decoder: 108 inputs x 10 basis slots
CIM_GAMMA0 = 0.08         # chip_smoke.py's crossbar IR drop


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel wrappers, imported only here."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops
    return lambda v, w, att, array_size: torch.from_numpy(np.array(
        ops.cim_mac(jnp.asarray(v.numpy()), jnp.asarray(w.numpy()),
                    jnp.asarray(att.numpy()), array_size=array_size,
                    adc_bits=8, in_scale=IN_SCALE)))


def _cim_lsb(array_size, in_scale=IN_SCALE):
    """The ADC step as ``ops.cim_mac`` computes it (the kernel and the
    plain version round it to f32)."""
    return array_size * in_scale / 255.0


def plain_readouts(v, w, atten, array_size, in_scale=IN_SCALE):
    """``ref.cim_mac_ref``'s readouts [8, B, T, C]. Run on one array's rows
    with the codes cut to bit plane k, it returns 2^k * readout_k exactly:
    the psum of plane k is the full codes', every other plane reads 0."""
    b, r = v.shape
    n_arrays = -(-r // array_size)
    code = w.to(torch.int32)
    out = torch.empty((8, b, n_arrays, w.shape[1]), dtype=torch.float32)
    for k in range(8):
        plane = (torch.sign(code) * (code.abs() & (1 << k))).to(torch.int8)
        for t in range(n_arrays):
            rows = slice(t * array_size, min(r, (t + 1) * array_size))
            out[k, :, t] = tref.cim_mac_ref(
                v[:, rows], plane[rows].contiguous(), atten[rows],
                array_size, 8, in_scale) / 2.0 ** k
    return out


def _cim_tie_inputs(array_size):
    """R = 1080 at atten 1 (gamma0 0). Each batch row has three live rows
    whose values read another plane-0 readout if summed in another order:
    in the ragged last array for the first half of the batch, in array 0
    (across its 256-row lists at As 1024) for the second; the arrays
    without ties hold sparse random values. Returns v, w, atten and the
    two halves' (first, last) rows."""
    rng = np.random.default_rng(15 + array_size)
    b, r, c = 20, DEC_ROWS, 40
    lsb = np.float32(_cim_lsb(array_size))
    v = _sparse(rng, b, r, 0.3)
    ragged = r - r % array_size
    v[:, ragged:] = 0.0
    v[:, :array_size] = 0.0
    first = [ragged + 6, ragged + 26, r - 5]
    second = [100, 300, 700] if array_size > 512 else [10, 100, 200]
    ties = _order_ties(b, lsb, rng)
    half = b // 2
    v[:half, first] = ties[:half]
    v[half:, second] = ties[half:]
    w = rng.integers(-128, 128, (r, c)).astype(np.int8)
    w[first + second] = 1
    att = tcim.row_attenuation(
        r, tcim.CIMConfig(array_size=array_size, gamma0=0.0), "cpu")
    halves = ((first[0], first[-1], slice(0, half)),
              (second[0], second[-1], slice(half, b)))
    return torch.from_numpy(v), torch.from_numpy(w), att, halves


def _cim_inputs(kind, b, r, c, array_size, seed):
    """v [B, R], w [R, C] and the main path's attenuation. ``basis``: the
    quantised basis of CF-KAN-1's decoder ASP on inputs that batch rows
    mostly share (4 of each input's 10 slots live per batch row, fewer for
    a group); ``dense``: 8-bit WL values with no zero; ``ties``:
    ``_cim_tie_inputs`` (b, r, c fixed there). Codes in [-128, 127], with
    -128 and 127 common."""
    if kind == "ties":
        return _cim_tie_inputs(array_size)[:3]
    rng = np.random.default_rng(seed)
    if kind == "basis":
        asp = tc1.MODEL.asp_dec
        n_in = r // asp.n_basis
        x = (rng.uniform(-1.0, 1.0, n_in)
             + 0.05 * rng.normal(size=(b, n_in))).astype(np.float32)
        x = tk.bound_input(torch.from_numpy(x), asp)
        v = tcim.quantize_wl(tq.quantized_basis(
            x, tq.hemi_for(asp, "cpu"), asp).reshape(b, -1), 8)
    else:
        v = torch.from_numpy(
            (rng.integers(1, 256, (b, r)) / 255.0).astype(np.float32))
    w = rng.integers(-128, 128, (r, c)).astype(np.int8)
    w[rng.random((r, c)) < 0.05] = -128
    w[rng.random((r, c)) < 0.05] = 127
    att = tcim.row_attenuation(
        r, tcim.CIMConfig(array_size=array_size, gamma0=CIM_GAMMA0), "cpu")
    return v.contiguous(), torch.from_numpy(w), att


def _assert_cim_bar(got, want, v, w, atten, array_size, steps_ok):
    """got within chip_smoke.py's bar of want: atol 2e-3, rtol 1e-4 plus
    1e-6 * sum|2^k * readout| (bounded from above). With ``steps_ok`` a
    larger difference may be a whole number of ADC steps, in under 0.1% of
    the outputs (the JAX package sums its psums in its own order)."""
    lsb = _cim_lsb(array_size)
    n_arrays = -(-v.shape[1] // array_size)
    mass = ((v * atten).abs() @ w.to(torch.float32).abs()
            + n_arrays * 255 * lsb / 2)
    err = (got - want).abs()
    tol = 2e-3 + 1e-4 * want.abs() + 1e-6 * mass
    off = err > tol
    if not steps_ok:
        assert not bool(off.any()), float((err - tol).max())
        return
    steps = torch.round(err / lsb)
    assert not bool((off & ((steps < 1)
                            | ((err - steps * lsb).abs() > tol))).any())
    assert float(off.float().mean()) < 1e-3


CIM_ORDER_CASES = [(40, DEC_ROWS, 48, 256), (40, DEC_ROWS, 48, 1024),
                   (9, 100, 17, 64)]


@pytest.mark.parametrize("kind", ["basis", "dense"])
@pytest.mark.parametrize("b,r,c,array_size", CIM_ORDER_CASES)
def test_cim_order_against_plain_and_jax(jops, kind, b, r, c, array_size):
    """``readout_order``'s readouts are the plain version's bit for bit, at
    the decoder's 1080 rows (a ragged last array at As 256 and 1024) and at
    a narrow shape; its output at every split is within the bar of the
    plain version and of JAX's ``ops.cim_mac`` (interpret mode)."""
    v, w, att = _cim_inputs(kind, b, r, c, array_size, seed=r + array_size)
    assert bool((w == -128).any()) and r % array_size
    readouts, sums, pairs = readout_order(v, w, att, array_size,
                                          _cim_lsb(array_size))
    np.testing.assert_array_equal(
        readouts.numpy(), plain_readouts(v, w, att, array_size).numpy())
    assert bool(readouts[7].any())              # plane 7, from -128
    want = tref.cim_mac_ref(v, w, att, array_size, 8, IN_SCALE)
    oracle = jops(v, w, att, array_size)
    n_arrays = sums.shape[1]
    for parts in sorted({1, 2, launch_split(b, r, c, array_size)[0],
                         n_arrays}):
        got = sum_over_arrays(sums, min(parts, n_arrays))
        _assert_cim_bar(got, want, v, w, att, array_size, steps_ok=False)
        _assert_cim_bar(got, oracle, v, w, att, array_size, steps_ok=True)
    if kind == "dense":
        assert pairs == v.numel()               # every row, no padding
    else:
        assert pairs < 0.75 * v.numel()


@pytest.mark.parametrize("array_size", [256, 1024])
def test_cim_order_where_order_matters(array_size):
    """Only the row order gives the plain version's readouts on
    ``_cim_tie_inputs``: in the ragged last array, and across the lists of
    an array at As 1024."""
    v, w, att, halves = _cim_tie_inputs(array_size)
    want = tref.cim_mac_ref(v, w, att, array_size, 8, IN_SCALE)
    for first, last, rows in halves:
        swap = torch.arange(v.shape[1])
        swap[[first, last]] = swap[[last, first]]
        reordered = tref.cim_mac_ref(v[:, swap], w[swap], att, array_size, 8,
                                     IN_SCALE)
        assert bool((reordered != want)[rows].all())
    readouts, sums, _ = readout_order(v, w, att, array_size,
                                      _cim_lsb(array_size))
    np.testing.assert_array_equal(
        readouts.numpy(), plain_readouts(v, w, att, array_size).numpy())
    _assert_cim_bar(sum_over_arrays(sums, 2), want, v, w, att, array_size,
                    steps_ok=False)


def test_cim_iterated_pairs_in_a_ragged_array():
    """readout_order's count on a hand-counted case: R = 300 at As 256 (a
    ragged array of 44 rows), one group of three batch rows, rows 0 and 1
    live in array 0 and row 299 in the ragged one (each list padded to 4
    rows); the launcher's split at CF-KAN-1's shapes."""
    w = torch.ones((300, 3), dtype=torch.int8)
    v = torch.zeros((3, 300))
    v[0, 0] = v[2, 1] = v[1, 299] = 1.0
    readouts, sums, pairs = readout_order(v, w, torch.ones(300), 256, 0.01)
    assert pairs == (4 + 4) * 3
    assert torch.equal(sum_over_arrays(sums, 2), torch.ones((3, 3)))
    # encoder: 16 blocks over 640 arrays; decoder: 16 x 128 over 5 and 2
    assert launch_split(256, 163840, 108, 256) == (214, 3)
    assert launch_split(256, DEC_ROWS, 16384, 256) == (3, 2)
    assert launch_split(256, DEC_ROWS, 16384, 1024) == (2, 1)


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


# (inputs, B, R, C, As): the decoder's rows (ragged last array) at its
# batch, at B = 1, with B and C ragged (37, 108 and 1); order ties; As 128
# over 13 arrays with a ragged B; the JAX suite's narrow shape
CIM_KERNEL_CASES = [("basis", 256, DEC_ROWS, 108, 256),
                    ("basis", 1, DEC_ROWS, 108, 256),
                    ("dense", 37, DEC_ROWS, 108, 1024),
                    ("dense", 20, DEC_ROWS, 1, 256),
                    ("ties", 20, DEC_ROWS, 40, 256),
                    ("ties", 20, DEC_ROWS, 40, 1024),
                    ("basis", 70, 1600, 200, 128),
                    ("dense", 9, 100, 17, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,r,c,array_size", CIM_KERNEL_CASES)
def test_cim_mac_kernel_matches_its_order(cuda, kind, b, r, c, array_size):
    """The ``cim_mac`` kernel gives ``readout_order``'s output bit for bit,
    split as the launcher splits it; a second launch the same; its
    ``rows_iterated`` the copy's count; and the plain version's output
    within the bar, with no ADC step apart."""
    v, w, att = _cim_inputs(kind, b, r, c, array_size, seed=b + r + c)
    lsb = _cim_lsb(array_size)
    _, sums, pairs = readout_order(v, w, att, array_size, lsb)
    n_scratch = tbuild.load().cim_mac_scratch(b, r, c, array_size)
    parts = n_scratch // (b * c) or 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert parts == launch_split(b, r, c, array_size, sms)[0]
    v_c, w_c, att_c = v.to(cuda), w.to(cuda), att.to(cuda)
    counter = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = tcm.cim_mac(v_c, w_c, att_c, array_size=array_size, lsb=lsb,
                      rows_iterated=counter)
    again = tops.cim_mac(v_c, w_c, att_c, array_size=array_size, adc_bits=8,
                         in_scale=IN_SCALE)
    want = tref.cim_mac_ref(v_c, w_c, att_c, array_size, 8, IN_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sum_over_arrays(sums, parts))
    assert torch.equal(again, got)
    assert int(counter) == pairs
    _assert_cim_bar(got.cpu(), want.cpu(), v, w, att, array_size,
                    steps_ok=False)


@pytest.mark.cuda
@pytest.mark.parametrize("array_size", [64, 256, 1024])
def test_cim_mac_kernel_adc_at_half_steps(cuda, array_size):
    """``cim_mac``'s ADC alone: one live row per output in 2.5 arrays,
    atten 1 and codes of 1, -1 and -128, so each output is one readout
    times 1, 1 or 128; values one ulp around .5 LSB steps, readouts of
    2^31 LSB and more (the kernel converts none to an integer), LSBs inside
    and outside [2^-120, 2^120]. Bitwise the plain version on the card."""
    rng = np.random.default_rng(array_size)
    r = 2 * array_size + array_size // 2
    w = torch.tensor([[1, -1, -128]], dtype=torch.int8).repeat(r, 1)
    att = torch.ones(r, device=cuda)
    large = []
    for in_scale in (1.2e-37, 1e-6, 0.2, 1.0, 7.3, 1e7, 2e37):
        lsb = np.float32(array_size * in_scale / 255.0)
        big = [m * float(lsb) for m in (2.0 ** 31, 3 * 2.0 ** 33, 2.0 ** 40)]
        vals = np.concatenate([_half_step_values(lsb, rng), np.array(
            [x for x in big if 0 < x < 3e38], dtype=np.float32)])
        v = np.zeros((len(vals), r), dtype=np.float32)
        rows = np.arange(len(vals))
        v[rows, (rows * 37) % r] = vals        # one row, in any array
        v_c, w_c = torch.from_numpy(v).to(cuda), w.to(cuda)
        got = tops.cim_mac(v_c, w_c, att, array_size=array_size, adc_bits=8,
                           in_scale=in_scale)
        want = tref.cim_mac_ref(v_c, w_c, att, array_size, 8, in_scale)
        large.append(bool((want[:, 0] / float(lsb) >= 2 ** 31).any()))
        assert torch.equal(got, want), f"in_scale={in_scale}"
    assert any(large)

"""Serve CF-KAN-1 at full width on one CUDA card through the port's
hand-written kernels, and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: the kernels in ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together), with the build time.
3. Kernels against their plain versions on the same inputs, at the shapes
   the main path gives them (CF-KAN-1 encoder and decoder, batch 256, inputs
   from the synthetic users). ``kan_fused`` is held to
   ``|kernel - plain| <= 1e-6 * sum_{i,s} |E[b,i,s] * codes[i,s,o] * scale[o]|``
   (its f32 sums run over up to 163,840 terms in another order).
   ``cim_mac`` (As in 128..1024, gamma0 0.08) is held to ``atol 2e-3,
   rtol 1e-4`` (the JAX suite's bar, set at R <= 256) plus the same
   ``1e-6 * sum|terms|``, the terms being ``2^k * readout`` over up to 1280
   arrays x 8 slices summed in another order; a larger difference must be a
   whole number of ADC steps, in under 0.1% of the outputs.
   ``cim_mac_tiled`` (As in 128..1024, Cc 64, gamma0 0.08, gains from
   ``variation.grid_gain`` at sigma 0.05, seed 0) takes the WL values in the
   physical order that ``chip.place_layer`` gives them and must give
   bit-identical int32 codes. Times come from CUDA events with the L2 cache
   flushed before every launch; ``bound_ms`` is the larger of bytes over
   3.35 TB/s and f32 operations over 67 TFLOP/s (H100 SXM data sheet).
4. The main path, CF-KAN-1 from ``init(seed=0)`` and 1024 synthetic users
   served in batches of 256 through ``kan.apply``, in two runs, each with
   the launch counts zeroed just before and read just after:
   (a) Phase-A stats on two batches and one deploy each for ``fused``,
   ``cim`` uniform and ``cim`` KAN-SAM (As 256): ``kan_fused`` and
   ``cim_mac`` must be launched; (b) ``kan.deploy`` to ``cim_tiled``
   uniform and KAN-SAM (As 256, Cc 64, gamma0 0.08, sigma 0.05) from the
   same stats, with the chip report: ``cim_mac_tiled`` must be launched.
5. A small-input reference: a narrow CF-KAN served layer by layer on the
   card and on the CPU (plain versions) from one artifact and one input.
6. Fig. 18 on the kernel path: one 64 -> 64 KAN layer (G=8, batch 128),
   gamma0 0.2, sigma 0.05, chip seeds 0-2, As 128..1024, uniform and
   KAN-SAM mapping: the uniform error against ``lut`` must grow with As and
   KAN-SAM must be below uniform at As 1024. One As-1024 cell runs once more
   with a generator, through the noisy plain readout, on the card.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import cf_kan_1  # noqa: E402
from repro_torch.core import kan, kan_sam, quant  # noqa: E402
from repro_torch.data import cf_synth  # noqa: E402
from repro_torch.hw import chip, cim, tiles, variation  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import cf_kan  # noqa: E402

PEAK_F32 = 67e12          # FLOP/s, H100 SXM, outside the tensor cores
PEAK_BYTES = 3.35e12      # B/s, H100 SXM HBM3
BATCH, N_USERS = 256, 1024
ARRAY_SIZES = (128, 256, 512, 1024)
SERVE_AS = 256
GAMMA0 = 0.08
TILE_COLS, SIGMA = 64, 0.05   # cim_tiled: columns per tile, cell variation
ORDER_REL = 1e-6          # summation-order bound, relative to sum |terms|
CIM_ATOL, CIM_RTOL = 2e-3, 1e-4
CIM_MAX_STEP_SHARE = 1e-3
METRIC_TOL = 2e-3         # fused vs lut Recall@20 / NDCG@20 (2 of 1024 users)
SOURCES = {
    "kan_fused": ("src/repro_torch/kernels/csrc/kan_fused.cu",
                  "src/repro/kernels/kan_fused.py:99"),
    "cim_mac": ("src/repro_torch/kernels/csrc/cim_mac.cu",
                "src/repro/kernels/cim_mac.py:148"),
    "cim_mac_tiled": ("src/repro_torch/kernels/csrc/cim_mac_tiled.cu",
                      "src/repro/kernels/cim_mac.py:111"),
}
# Fig. 18 phase: the JAX package's kernel-path means (uniform, KAN-SAM) on
# its own random weights and draws, printed for orientation only
FIG18_GAMMA0, FIG18_SEEDS = 0.2, (0, 1, 2)
FIG18_JAX = {128: (0.1330, 0.0759), 256: (0.2382, 0.1144),
             512: (0.4176, 0.1950), 1024: (0.6455, 0.2993)}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class Timer:
    """Median per-call device time from CUDA events, each call preceded by
    a write of 128 MB so that no input is left in the 50 MB L2 cache."""

    def __init__(self, dev):
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def bound(ops_f32: float, n_bytes: float):
    t_ops, t_bytes = ops_f32 / PEAK_F32, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --- phase 3: kernels against their plain versions --------------------------

def check_kan_fused(timer, label, x, layer, asp):
    """x: bounded layer input [B, I]; layer: a DeployedLayer."""
    codes, scale, hemi = layer.codes, layer.scale.reshape(-1), layer.hemi
    got = ops.kan_spline_fused_deployed(x, codes, scale, asp, hemi=hemi)
    want = ref.kan_spline_ref(x, codes, scale, asp, hemi)
    e = quant.quantized_basis(x, hemi, asp).reshape(x.shape[0], -1)
    c = codes.to(torch.float32).reshape(e.shape[1], -1)
    mass = (e.abs() @ c.abs()) * scale.abs()          # sum |terms| per output
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"kan_fused {label}: not finite")
    worst = float((err / mass.clamp_min(1e-30)).max())
    check(bool((err <= ORDER_REL * mass).all()),
          f"kan_fused {label}: |kernel - plain| / sum|terms| = {worst:.3g} "
          f"> {ORDER_REL}")
    b, i = x.shape
    o = codes.shape[-1]
    c_deq = quant.dequantize_coeffs(codes, layer.scale).reshape(e.shape[1], o)
    row = dict(shape=label, B=b, I=i, O=o, max_abs_err=float(err.max()),
               max_err_over_sum_abs_terms=worst,
               ms=timer.ms(lambda: ops.kan_spline_fused_deployed(
                   x, codes, scale, asp, hemi=hemi), reps=20),
               plain_ms=timer.ms(lambda: ref.kan_spline_ref(
                   x, codes, scale, asp, hemi), reps=5),
               library_ms=timer.ms(lambda: torch.matmul(e, c_deq), reps=20))
    flops = 2.0 * float((e != 0).sum()) * o + b * o   # K+1 taps, epilogue
    n_bytes = (x.numel() * 4 + codes.numel() + scale.numel() * 4
               + hemi.numel() * 4 + b * o * 4)
    row["bound_ms"], row["bound_by"] = bound(flops, n_bytes)
    return row


def check_cim_mac(timer, label, v, w, array_size):
    """v: WL values [B, R]; w: codes [R, C]; uniform row attenuation."""
    ccfg = cim.CIMConfig(array_size=array_size, gamma0=GAMMA0)
    att = cim.row_attenuation(w.shape[0], ccfg, v.device)
    kw = dict(array_size=array_size, adc_bits=ccfg.adc_bits,
              in_scale=ccfg.adc_in_scale)
    got = ops.cim_mac(v, w, att, **kw)
    want = ref.cim_mac_ref(v, w, att, array_size, ccfg.adc_bits,
                           ccfg.adc_in_scale)
    check(bool(torch.isfinite(got).all()), f"cim_mac {label}: not finite")
    lsb = array_size * ccfg.adc_in_scale / (2 ** ccfg.adc_bits - 1)
    n_arrays = -(-v.shape[1] // array_size)
    # sum over arrays and slices of |2^k * readout|, bounded from above
    mass = ((v * att).abs() @ w.to(torch.float32).abs()
            + n_arrays * (2 ** ccfg.adc_bits - 1) * lsb / 2)
    err = (got - want).abs()
    tol = CIM_ATOL + CIM_RTOL * want.abs() + ORDER_REL * mass
    off = err > tol
    steps = torch.round(err / lsb)
    resid = (err - steps * lsb).abs()
    bad = off & ((steps < 1) | (resid > tol))
    if bool(bad.any()):
        j = int(torch.argmax(torch.where(bad, resid - tol, -torch.inf)))
        raise AssertionError(
            f"cim_mac {label}: {int(bad.sum())} differences are not whole "
            f"ADC steps; worst: plain {float(want.flatten()[j]):.6g}, "
            f"kernel {float(got.flatten()[j]):.6g}, tolerance "
            f"{float(tol.flatten()[j]):.3g}, lsb {lsb:.4g}")
    share = float(off.float().mean())
    check(share < CIM_MAX_STEP_SHARE,
          f"cim_mac {label}: {share:.3%} of outputs off by ADC steps")
    b, r = v.shape
    c = w.shape[1]
    mag = w.to(torch.int32).abs()
    popcount = sum(((mag >> k) & 1) for k in range(8)).sum(dim=1)  # [R]
    live = ((v * att) != 0).sum(dim=0)                              # [R]
    adds = float((live.to(torch.float64) * popcount.to(torch.float64)).sum())
    # one add per set bit and live row; the ADC's divide, round, multiply and
    # weighted add per (b, array, c, bit); v * atten once per (b, r)
    flops = adds + 4.0 * 8 * b * n_arrays * c + b * r
    n_bytes = v.numel() * 4 + w.numel() + att.numel() * 4 + b * c * 4
    row = dict(shape=label, B=b, R=r, C=c, array_size=array_size,
               max_abs_err=float(err.max()), adc_step_share=share,
               ms=timer.ms(lambda: ops.cim_mac(v, w, att, **kw), reps=10),
               plain_ms=timer.ms(lambda: ref.cim_mac_ref(
                   v, w, att, array_size, ccfg.adc_bits, ccfg.adc_in_scale),
                   reps=3, warmup=1),
               library_ms=None)
    row["bound_ms"], row["bound_by"] = bound(flops, n_bytes)
    return row


def chip_cfg(array_size, gamma0=GAMMA0, seed=0):
    return chip.ChipConfig(
        tile=tiles.TileConfig(array_size=array_size, tile_cols=TILE_COLS,
                              gamma0=gamma0),
        variation=variation.VariationConfig(sigma=SIGMA, seed=seed))


def check_cim_mac_tiled(timer, label, wl, codes, layer_uid, array_size):
    """wl: WL values [B, R] in logical order; codes: the layer's [I, S, O]
    int8 codes, placed (uniform mapping) as the cim_tiled deploy places
    them, so the kernel sees the main path's physical-order inputs."""
    ccfg = chip_cfg(array_size)
    tiled = chip.place_layer(codes, None, ccfg, layer_uid=layer_uid)
    v = torch.where(tiled.valid, wl[:, tiled.logical_of_phys.long()], 0.0)
    w, g = tiled.w_phys, tiled.gain
    tile = ccfg.tile
    att = tiles.slot_attenuation(v.shape[1], tile, v.device)
    kw = dict(array_size=array_size, adc_bits=tile.adc_bits,
              in_scale=tile.adc_in_scale)
    got = ops.cim_mac_tiled(v, w, att, gain=g, **kw)
    want = ref.cim_mac_tiled_ref(v, w, g, att, array_size, tile.adc_bits,
                                 tile.adc_in_scale)
    n_off = int((got != want).sum())
    check(n_off == 0, f"cim_mac_tiled {label}: {n_off} codes differ from "
          "the plain version")
    b, r = v.shape
    c = w.shape[1]
    mag = w.to(torch.int32).abs()
    popcount = sum(((mag >> k) & 1) for k in range(8)).sum(dim=1)   # [R]
    nonzero = (w != 0).sum(dim=1)                                   # [R]
    live = ((v * att) != 0).sum(dim=0)                              # [R]
    # per live (b, r): one add per set code bit and one gain multiply per
    # nonzero cell; the ADC's divide, round, shift and add per (b, tile, c,
    # bit); v * atten once per (b, r)
    per_row = (popcount + nonzero).to(torch.float64)
    flops = (float((live.to(torch.float64) * per_row).sum())
             + 4.0 * 8 * b * (r // array_size) * c + b * r)
    n_bytes = (v.numel() * 4 + w.numel() + g.numel() * 4 + att.numel() * 4
               + b * c * 4)
    row = dict(shape=label, B=b, R=r, C=c, array_size=array_size,
               max_abs_err=float((got - want).abs().max()), codes_differing=0,
               ms=timer.ms(lambda: ops.cim_mac_tiled(v, w, att, gain=g, **kw),
                           reps=10),
               plain_ms=timer.ms(lambda: ref.cim_mac_tiled_ref(
                   v, w, g, att, array_size, tile.adc_bits,
                   tile.adc_in_scale), reps=3, warmup=1),
               library_ms=None)
    row["bound_ms"], row["bound_by"] = bound(flops, n_bytes)
    return row


# --- phase 4: the main path -------------------------------------------------

def enc_only(deployed):
    """The encoder layer of a CF-KAN artifact as a one-layer artifact."""
    spec = dataclasses.replace(deployed.spec, dims=deployed.spec.dims[:2],
                               asp=deployed.spec.asp[:1],
                               layer_names=("enc",))
    return kan.DeployedKAN(deployed.layers[:1], spec)


def serve(deployed, x_all):
    """Serve every user in batches through kan.apply; returns the scores and
    the host time of each batch (ending in a synchronize), in ms."""
    scores, times = [], []
    for s in range(0, x_all.shape[0], BATCH):
        t0 = time.perf_counter()
        y = kan.apply(deployed, x_all[s:s + BATCH])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(y.shape == (min(BATCH, x_all.shape[0] - s), x_all.shape[1]),
              f"scores have shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "scores are not finite")
        scores.append(y)
    return torch.cat(scores), times


def rel_err(a, b):
    return float((a - b).abs().mean() / b.abs().mean())


# --- phase 5: a small-input reference ---------------------------------------

def small_reference(dev):
    """A narrow CF-KAN (128 items, hidden 16) deployed once on the CPU and
    copied to the card; each layer is fed one bounded input on both, so the
    card's kernels meet the CPU's plain versions on identical inputs."""
    cfg = dataclasses.replace(cf_kan_1.SMOKE_MODEL, n_items=128, hidden=16,
                              backend="fused")
    ds = cf_synth.generate(n_users=192, n_items=128, seed=1)
    params = cf_kan.init(1, cfg, device="cpu")
    stats = cf_kan.collect_layer_stats(
        params, [torch.from_numpy(ds.observed[:64]),
                 torch.from_numpy(ds.observed[64:128])], cfg)
    ccfg = cim.CIMConfig(array_size=64, gamma0=GAMMA0)
    tcfg = chip.ChipConfig(
        tile=tiles.TileConfig(array_size=64, tile_cols=16, gamma0=GAMMA0),
        variation=variation.VariationConfig(sigma=SIGMA, seed=0))
    spec = cfg.kan_spec
    variants = {
        "fused": (lambda: cf_kan.deploy(params, cfg), (2e-5, 1e-5)),
        "cim": (lambda: cf_kan.deploy(params, cfg, cim_cfg=ccfg),
                (CIM_ATOL, CIM_RTOL)),
        "cim_sam": (lambda: cf_kan.deploy(params, cfg, cim_cfg=ccfg,
                                          use_sam=True, stats=stats),
                    (CIM_ATOL, CIM_RTOL)),
        "cim_tiled": (lambda: kan.deploy(params, spec.with_backend(
            "cim_tiled", cim=tcfg)), (2e-5, 1e-5)),
        "cim_tiled_sam": (lambda: kan.deploy(params, spec.with_backend(
            "cim_tiled", cim=tcfg, use_sam=True), stats=stats),
            (2e-5, 1e-5))}
    worst = {}
    for name, (make, (atol, rtol)) in variants.items():
        dep = make()
        x = torch.from_numpy(ds.observed[128:])
        worst[name] = 0.0
        for i, layer in enumerate(dep.layers):
            lspec = dep.spec.layer(i)
            spec1 = dataclasses.replace(
                dep.spec, dims=(lspec.in_dim, lspec.out_dim),
                asp=(lspec.asp,), layer_names=(), bound_input=False)
            on_card = dataclasses.replace(layer, **{
                f.name: getattr(layer, f.name).to(dev)
                for f in dataclasses.fields(layer)
                if getattr(layer, f.name) is not None})
            xb = kan.bound_input(x, lspec.asp)
            want = kan.apply(kan.DeployedKAN((layer,), spec1), xb)
            got = kan.apply(kan.DeployedKAN((on_card,), spec1),
                            xb.to(dev)).cpu()
            err = (got - want).abs()
            check(bool((err <= atol + rtol * want.abs()).all()),
                  f"small reference {name} layer {i}: card and CPU differ "
                  f"by {float(err.max()):.3g}")
            worst[name] = max(worst[name], float(err.max()))
            x = want
    return worst


# --- phase 6: Fig. 18 on the kernel path ------------------------------------

def fig18(dev):
    """Relative error of the chip against ``lut`` over As and chip seeds,
    uniform and KAN-SAM (the JAX package's bench_chip setting, rebuilt from
    the port's own generator)."""
    spec = kan.KANSpec.single(64, 64, quant.ASPConfig(grid_size=8),
                              base_activation="")
    gen = torch.Generator().manual_seed(0)
    params = kan.init(gen, spec, device=dev)
    x = torch.clamp(torch.randn((128, 64), generator=gen) * 0.35, -0.999,
                    0.999).to(dev)
    xs = torch.clamp(torch.randn((512, 64), generator=gen) * 0.35, -0.999,
                     0.999).to(dev)
    asp = spec.asp[0]
    stats = kan_sam.update_stats(kan_sam.init_stats(64, asp, dev),
                                 kan.bound_input(xs, asp), asp)
    y_ideal = kan.apply(kan.deploy(params, spec.with_backend("lut")), x)
    denom = float(torch.linalg.norm(y_ideal))

    def make_eval(a, sam, generator=None):
        def eval_seed(seed):
            dep = kan.deploy(params, spec.with_backend(
                "cim_tiled", cim=chip_cfg(a, FIG18_GAMMA0, seed),
                use_sam=sam), stats=stats if sam else None)
            y = kan.apply(dep, x, generator=generator)
            check(bool(torch.isfinite(y).all()), "Fig. 18: not finite")
            return float(torch.linalg.norm(y - y_ideal)) / denom
        return eval_seed

    rows = {sam: {r["As"]: r for r in variation.sweep_array_size(
        lambda a, sam=sam: make_eval(a, sam), ARRAY_SIZES, FIG18_SEEDS)}
        for sam in (False, True)}
    uni = [rows[False][a]["mean"] for a in ARRAY_SIZES]
    top = ARRAY_SIZES[-1]
    noisy = make_eval(top, False, torch.Generator(device=dev).manual_seed(
        10_000))(0)
    for a in ARRAY_SIZES:
        print(f"Fig. 18 As={a}: uniform {rows[False][a]['mean']:.4f} "
              f"(ci95 {rows[False][a]['ci95']:.4f}), KAN-SAM "
              f"{rows[True][a]['mean']:.4f} (ci95 {rows[True][a]['ci95']:.4f})"
              f"; JAX package {FIG18_JAX[a][0]:.4f} / {FIG18_JAX[a][1]:.4f}")
    print(f"Fig. 18 As={top} uniform seed 0 with readout noise: "
          f"{noisy:.4f} (without: {rows[False][top]['values'][0]:.4f})")
    check(all(lo < hi for lo, hi in zip(uni, uni[1:])),
          f"Fig. 18: uniform error does not grow with As: {uni}")
    check(rows[True][top]["mean"] < rows[False][top]["mean"],
          f"Fig. 18: KAN-SAM does not recover at As={top}")
    check(np.isfinite(noisy), "Fig. 18: noisy readout not finite")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    print(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{build.library_path().name}")

    # model, artifact and data of the main path (set-up)
    cfg = cf_kan_1.MODEL
    cfg_fused = dataclasses.replace(cfg, backend="fused")
    asp_e, asp_d = cfg.asp_enc, cfg.asp_dec
    params = cf_kan.init(0, cfg)
    t0 = time.perf_counter()
    ds = cf_synth.generate(n_users=N_USERS, n_items=cfg.n_items, seed=0)
    x_all = torch.from_numpy(ds.observed).to(dev)
    held = torch.from_numpy(ds.held_out).to(dev)
    print(f"data: {N_USERS} users x {cfg.n_items} items in "
          f"{time.perf_counter() - t0:.1f} s; params {cfg.n_params:,}")

    # 3. kernels against their plain versions at the main path's shapes
    timer = Timer(dev)
    art = cf_kan.deploy(params, cfg_fused)
    enc, dec = art.layers
    xe = kan.bound_input(x_all[:BATCH], asp_e)
    h = (ref.kan_spline_ref(xe, enc.codes, enc.scale.reshape(-1), asp_e,
                            enc.hemi)
         + kan.base_branch(xe, enc.w_base, "relu"))
    xd = kan.bound_input(h, asp_d)
    rows = {"kan_fused": [check_kan_fused(timer, "enc", xe, enc, asp_e),
                          check_kan_fused(timer, "dec", xd, dec, asp_d)],
            "cim_mac": [], "cim_mac_tiled": []}
    for uid, (label, x, layer, asp) in enumerate((("enc", xe, enc, asp_e),
                                                  ("dec", xd, dec, asp_d))):
        wl = cim.quantize_wl(quant.quantized_basis(x, layer.hemi, asp)
                             .reshape(x.shape[0], -1), 8)
        w = layer.codes.reshape(wl.shape[1], -1)
        for a in ARRAY_SIZES:
            rows["cim_mac"].append(
                check_cim_mac(timer, f"{label} As={a}", wl, w, a))
            rows["cim_mac_tiled"].append(check_cim_mac_tiled(
                timer, f"{label} As={a}", wl, layer.codes, uid, a))
    for kname, krows in rows.items():
        for r in krows:
            print(f"kernel {kname} {r['shape']}: max|err| "
                  f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']})")

    # 4a. the main path through fused and cim, with the launch counts
    # zeroed just before and read just after
    ccfg = cim.CIMConfig(array_size=SERVE_AS, gamma0=GAMMA0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = cf_kan.collect_layer_stats(
        params, [x_all[:BATCH], x_all[BATCH:2 * BATCH]], cfg_fused)
    deployed = {"fused": cf_kan.deploy(params, cfg_fused),
                "cim_uniform": cf_kan.deploy(params, cfg, cim_cfg=ccfg),
                "cim_sam": cf_kan.deploy(params, cfg, cim_cfg=ccfg,
                                         use_sam=True, stats=stats)}
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    served = {k: serve(d, x_all) for k, d in deployed.items()}
    launches_a = ops.launch_counts()
    print(f"main path (a): stats + 3 deploys {deploy_s:.2f} s; launches "
          f"{launches_a}")

    # 4b. the main path through cim_tiled, uniform and KAN-SAM, from the
    # same stats, with the launch counts zeroed just before and read after
    tcfg = chip_cfg(SERVE_AS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tiled = {"cim_tiled_uniform": kan.deploy(params, cfg.kan_spec.with_backend(
                 "cim_tiled", cim=tcfg)),
             "cim_tiled_sam": kan.deploy(params, cfg.kan_spec.with_backend(
                 "cim_tiled", cim=tcfg, use_sam=True), stats=stats)}
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    served.update({k: serve(d, x_all) for k, d in tiled.items()})
    launches_b = ops.launch_counts()
    print(f"main path (b): 2 deploys {deploy_s:.2f} s; launches "
          f"{launches_b}")
    launches = {"kan_fused": launches_a["kan_fused"],
                "cim_mac": launches_a["cim_mac"],
                "cim_mac_tiled": launches_b["cim_mac_tiled"]}
    for kname in SOURCES:
        check(launches[kname] > 0, f"{kname} was not launched on the path")
    for k, d in tiled.items():
        rep = chip.chip_report(d)
        print(f"chip report {k}: tiles allocated {rep['tiles_allocated']}, "
              f"used {rep['tiles_used']}, utilization "
              f"{rep['utilization']:.4f}, area {rep['area_mm2']:.2f} mm^2, "
              f"layers " + ", ".join(
                  f"{n}: grid {l['grid']} rows placed {l['rows_placed']} of "
                  f"{l['rows']}" for n, l in rep["layers"].items()))

    dep_lut = cf_kan.deploy(params, cfg)
    s_lut, _ = serve(dep_lut, x_all)
    s_fused = served["fused"][0]
    metrics = {}
    for k, (s, times) in {**served, "lut": (s_lut, [])}.items():
        metrics[k] = (float(cf_kan.recall_at_k(s, held, x_all)),
                      float(cf_kan.ndcg_at_k(s, held, x_all)))
        batch_ms = (f"; per batch of {BATCH}: median "
                    f"{np.median(times):.2f} ms, all "
                    f"{[round(t, 2) for t in times]}" if times else "")
        print(f"serve {k}: Recall@20 {metrics[k][0]:.6f} NDCG@20 "
              f"{metrics[k][1]:.6f}{batch_ms}")
    q = {k: quant.quantize_input(kan.bound_input(
        kan.apply(enc_only(d), x_all), asp_d), asp_d)
        for k, d in (("fused", deployed["fused"]), ("lut", dep_lut))}
    flip = float((q["fused"] != q["lut"]).float().mean())
    print(f"fused vs lut: max|score err| "
          f"{float((s_fused - s_lut).abs().max()):.3g}, mean rel "
          f"{rel_err(s_fused, s_lut):.3g}, decoder-input codes differing "
          f"{flip:.3g}")
    for kind in ("cim", "cim_tiled"):
        print(f"{kind} vs fused: mean rel score err uniform "
              f"{rel_err(served[kind + '_uniform'][0], s_fused):.4f}, SAM "
              f"{rel_err(served[kind + '_sam'][0], s_fused):.4f}")
    check(flip <= 1e-3, f"fused vs lut: {flip:.3g} decoder codes differ")
    for i, what in enumerate(("Recall@20", "NDCG@20")):
        d = abs(metrics["fused"][i] - metrics["lut"][i])
        check(d <= METRIC_TOL, f"fused vs lut {what} differ by {d:.3g}")

    # 5. small-input reference (card against CPU)
    worst = small_reference(dev)
    print(f"small reference, card vs CPU max|err|: {worst}")

    # 6. Fig. 18 on the kernel path
    fig18(dev)

    # result lines
    kernels = []
    for kname, krows in rows.items():
        on_path = [r for r in krows if r.get("array_size", SERVE_AS)
                   == SERVE_AS]          # one apply: the enc and dec shapes
        ms = sum(r["ms"] for r in on_path)
        bound_ms = sum(r["bound_ms"] for r in on_path)
        by = max(on_path, key=lambda r: r["bound_ms"])["bound_by"]
        lib = (None if any(r["library_ms"] is None for r in on_path)
               else sum(r["library_ms"] for r in on_path))
        kernels.append(dict(
            name=kname, route="cuda", source=SOURCES[kname][0],
            replaces=SOURCES[kname][1], launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in krows), ms=ms,
            plain_ms=sum(r["plain_ms"] for r in on_path), bound_ms=bound_ms,
            bound_by=by, library_ms=lib, per_shape=krows))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

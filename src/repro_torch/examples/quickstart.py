"""Quickstart: the paper's full pipeline on one KAN layer (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. build a KAN layer, deploy it ONCE (``kan.deploy``: int8 codes + scales,
   SH-LUT, bit-slices, SAM row map) and evaluate the frozen artifact on
   the registered backends through the single ``kan.apply`` entry point
   (float oracle, ASP-KAN-HAQ LUT baseline, the fused CUDA kernel, the
   simulated RRAM-ACIM crossbar with and without KAN-SAM),
2. show the ASP-KAN-HAQ structure (shared hemi-LUT, PowerGap decode),
3. price the whole thing with the calibrated 22nm cost model.

Without ``--device`` it runs on the card and raises if there is none;
``--device cpu`` runs it on the CPU, where ``fused`` and ``cim`` run their
kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import kan, kan_sam
from repro_torch.core.quant import ASPConfig
from repro_torch.hw import cim, cost_model, input_gen


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    asp = ASPConfig(grid_size=8, order=3, n_bits=8)
    print(f"ASP-KAN-HAQ: G={asp.grid_size} K={asp.order} n={asp.n_bits} "
          f"=> LD={asp.ld}, {asp.levels_per_interval} levels/knot-interval, "
          f"input range [0, {asp.n_levels - 1}], on {device}")

    # one KAN layer; train-time params, then a frozen artifact per backend
    spec = kan.KANSpec.single(in_dim=64, out_dim=32, asp=asp)
    params = kan.init(0, spec, device=device)
    gen = torch.Generator().manual_seed(1)
    x = (2 * torch.rand((128, 64), generator=gen) - 1).to(device)

    deployed = {b: kan.deploy(params, spec.with_backend(b))
                for b in ("ref", "lut", "fused")}
    hemi = deployed["lut"].layers[0].hemi
    print(f"SH-LUT (from the deployed artifact): {hemi.shape[0]}x"
          f"{hemi.shape[1]} entries (vs {asp.n_basis * 2**asp.n_bits} for "
          "per-basis conventional LUTs)")

    y_float = kan.train_apply(params, x, spec.with_backend("ref"))
    y_ref = kan.apply(deployed["ref"], x)
    y_q = kan.apply(deployed["lut"], x)
    y_f = kan.apply(deployed["fused"], x)
    out = {"float_vs_lut": float((y_float - y_q).abs().max()),
           "ref_vs_lut": float((y_ref - y_q).abs().max()),
           "lut_vs_fused": float((y_q - y_f).abs().max())}
    print(f"float vs deployed-lut err: {out['float_vs_lut']:.4f} "
          "(8-bit quantization)")
    print(f"deployed-ref vs deployed-lut err: {out['ref_vs_lut']:.4f} "
          "(input quantization only)")
    print(f"deployed-lut vs fused kernel err: {out['lut_vs_fused']:.2e} "
          "(same frozen artifact, f32 sums in another order)")

    # CIM crossbar backend with/without KAN-SAM: same deploy/apply contract
    stats = kan_sam.update_stats(kan_sam.init_stats(64, asp, device), x, asp)
    ccfg = cim.CIMConfig(array_size=512)
    cim_spec = spec.with_backend("cim", cim=ccfg)
    ideal_spec = dataclasses.replace(
        cim_spec, cim=dataclasses.replace(ccfg, gamma0=0.0))
    y_ideal = kan.apply(kan.deploy(params, ideal_spec), x)
    norm = float(y_ideal.abs().mean()) + 1e-9
    out["err_uniform"] = float((kan.apply(kan.deploy(params, cim_spec), x)
                                - y_ideal).abs().mean()) / norm
    dep_sam = kan.deploy(params, dataclasses.replace(cim_spec, use_sam=True),
                         stats=stats)
    out["err_sam"] = float((kan.apply(dep_sam, x) - y_ideal).abs().mean()
                           ) / norm
    print(f"RRAM-ACIM MAC error: uniform={out['err_uniform']:.4f}, "
          f"KAN-SAM={out['err_sam']:.4f} (artifact carries the row map: "
          f"atten[{tuple(dep_sam.layers[0].atten.shape)}], slices"
          f"{tuple(dep_sam.layers[0].slices.shape)})")

    # cost model
    c = cost_model.accelerator_cost(64 * asp.n_basis * 32)
    t = input_gen.scheme_table(3)
    out["area_mm2"], out["power_w"] = c.area_mm2, c.power_w
    print(f"cost model: {c.area_mm2:.4f} mm^2, {c.power_w*1e3:.2f} mW; "
          f"TM-DV-IG FOM vs voltage: {t['tmdv'].fom/t['voltage'].fom:.1f}x")
    print("OK")
    return out


if __name__ == "__main__":
    main()

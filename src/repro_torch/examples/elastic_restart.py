"""Elastic fault-tolerance demo (twin of ``examples/elastic_restart.py``):
train mistral-nemo SMOKE on a 4x2 mesh of ranks, checkpoint, "lose a pod",
resume the same run on a 2x2 mesh (other placements) and keep training,
then go back to 4x2.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart \\
        --device cpu [--meshes 4x2,2x2,4x2] [--steps 3,3,2]

Each phase is a separate ``torchrun`` of this module with ``--phase``
(one process per rank), like separate cluster incarnations. A resumed
phase restores through ``checkpoint.restore(shardings=)`` onto its own
mesh and checks that every restored leaf, gathered whole, equals the
saved file bit for bit. Without ``--device`` the ranks run on the card
(with NCCL, one card per rank, unless ``--dist-backend`` says otherwise).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def phase(args) -> None:
    """One incarnation: this process is one rank of a data x model mesh."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_synth
    from repro_torch.dist import sharding as shlib
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.train import place_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import TrainConfig, make_train_step

    device = resolve_device(args.device)
    backend = args.dist_backend or meshlib.default_backend(device)
    meshlib.init_process_group(backend, cuda_gloo=device.type == "cuda")
    data, model = (int(v) for v in args.mesh.split("x"))
    mesh = meshlib.make_host_mesh(model, device)
    if mesh.shape != (data, model):
        raise ValueError(f"mesh {args.mesh} needs {data * model} ranks")
    lead = meshlib.rank() == 0
    m = get_arch("mistral_nemo_12b", smoke=True).model
    opt = make_optimizer("adamw", warmup_cosine(3e-3, 2, 100))
    step_fn = make_train_step(m, opt, TrainConfig())
    dcfg = lm_synth.LMDataConfig(vocab=m.vocab, batch=8, seq_len=32)
    log = []
    with shlib.use_mesh(mesh):
        params = shlib.distribute_tree(tfm.init_model(0, m, device=device),
                                       mesh, tfm.param_spec(m))
        state = opt.init(params)
        start = 0
        if ckpt.latest_step(args.ckpt_dir) is not None:
            template = (params, state)
            (params, state), extra = ckpt.restore(
                args.ckpt_dir, template,
                shardings=shlib.shardings_of(template))
            start = extra["step"]
            n_same = ckpt.verify(args.ckpt_dir, (params, state), start)
            if lead:
                print(f"  resumed at step {start} on mesh {args.mesh}: "
                      f"{n_same} restored leaves bitwise equal to the "
                      f"saved ones", flush=True)
        for i in range(start, start + args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in lm_synth.batch_at(dcfg, i).items()}
            params, state, mtr = step_fn(params, state,
                                         place_batch(batch, mesh))
            loss = float(mtr["loss"])
            log.append({"step": i, "loss": loss})
            if lead:
                print(f"  [mesh {args.mesh}] step {i}: loss={loss:.4f}",
                      flush=True)
        ckpt.save(args.ckpt_dir, start + args.steps, (params, state),
                  extra={"step": start + args.steps})
    if lead and args.log:
        with open(args.log, "w") as f:
            json.dump(log, f)
    meshlib.destroy()


def run_phase(ckpt_dir: str, mesh: str, steps: int, *, device=None,
              dist_backend=None, log=None, timeout: float = 900) -> str:
    """One phase as ``torchrun --standalone`` of this module; returns its
    output and raises if it failed."""
    data, model = (int(v) for v in mesh.split("x"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(data * model), "-m",
           "repro_torch.examples.elastic_restart", "--phase",
           "--ckpt-dir", ckpt_dir, "--mesh", mesh, "--steps", str(steps)]
    for flag, val in (("--device", device), ("--dist-backend", dist_backend),
                      ("--log", log)):
        if val:
            cmd += [flag, val]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"phase on mesh {mesh} failed:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", action="store_true",
                    help="run one incarnation (under torchrun)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--mesh", default="4x2")
    ap.add_argument("--steps", default="3")
    ap.add_argument("--meshes", default="4x2,2x2,4x2")
    ap.add_argument("--device", default=None)
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--log", default="")
    args = ap.parse_args(argv)
    if args.phase:
        args.steps = int(args.steps)
        phase(args)
        return
    meshes = args.meshes.split(",")
    steps = [int(s) for s in (args.steps if "," in args.steps
                              else "3,3,2").split(",")]
    titles = ["phase 1: {} mesh", "phase 2: pod lost -> resume on {} mesh, "
              "resharded", "phase 3: pod restored -> back to {}"]
    with tempfile.TemporaryDirectory() as ck:
        for title, mesh, n in zip(titles, meshes, steps):
            print(title.format(mesh), flush=True)
            sys.stdout.write(run_phase(ck, mesh, n, device=args.device,
                                       dist_backend=args.dist_backend))
    print("OK: one logical run survived two mesh changes", flush=True)


if __name__ == "__main__":
    main()

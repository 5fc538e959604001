"""Training launcher (port of ``repro.launch.train``): restart-safe,
preemption-aware, mesh-aware.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \
        --smoke --steps 12 --batch 4 --seq 64 --ckpt-dir /tmp/ck \
        --save-every 5 --device cpu

Without ``--device`` it runs on the card and raises if there is none.

With ``--host-mesh`` every process is one rank of a (data = world // M,
model = M) mesh, M = ``--model-parallel``; start the ranks with torchrun:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch kan_llm --smoke --device cpu \
        --host-mesh --model-parallel 2 --steps 6 --batch 4 --seq 32

The parameters are initialised packed for M model shards, placed by
``param_spec`` as DTensors (the optimizer's moments likewise), each batch
is split by ``("batch", "seq")``, and the step runs under the mesh. The
resume goes through ``checkpoint.restore(shardings=)``, so a run saved on
one mesh resumes on another. Only rank 0 prints and writes checkpoints.
``--dist-backend`` defaults to ``launch.mesh.default_backend``: NCCL with
one rank per card, gloo on the CPU or for ranks sharing a card. Without
``--host-mesh``, ``--model-parallel`` is ignored, as in the reference.

Fault-tolerance behaviour (the reference's):
  * resumes from the latest complete checkpoint in --ckpt-dir (params,
    optimizer state and the step, which indexes the data stream),
  * SIGTERM/SIGINT trigger a final synchronous checkpoint, then exit 0,
  * an async checkpoint every --save-every steps,
  * straggler incidents (a step over 2.5x the rolling median) are logged.

The batches are ``lm_synth.batch_at(step)``; whisper's frames and
internvl2's patch embeddings are drawn from a ``torch.Generator`` seeded
by the step.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.data import lm_synth
from repro_torch.dist import fault
from repro_torch.dist import sharding as shlib
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train.train_step import TrainConfig, make_train_step



def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--host-mesh", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--kan-backend", default="",
                    help="override ModelConfig.kan_backend (the training "
                         "path dispatches through the same core.kan "
                         "registry as serving)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend with --host-mesh (default "
                         "nccl on the card, gloo on the CPU)")
    ap.add_argument("--losses-out", default="",
                    help="write main()'s result as JSON here (rank 0; "
                         "rank r > 0 to PATH.rank<r>)")
    ap.add_argument("--verify-restore", action="store_true",
                    help="after a resume, check every restored leaf "
                         "against the checkpoint's files, bit for bit")
    return ap.parse_args(argv)


_BATCH_NAMES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "loss_mask": ("batch", "seq"),
                "frames": ("batch", "seq", None),
                "vision_embeds": ("batch", None, None)}


def place_batch(batch: dict, mesh) -> dict:
    """A step's batch (the same on every rank) as DTensors split by
    their logical names; unchanged without a mesh."""
    if mesh is None:
        return batch
    return {k: shlib.local_to_dtensor(
        v, mesh, shlib.named_sharding(mesh, v.shape,
                                      _BATCH_NAMES[k]).placements)
        for k, v in batch.items()}


def stub_inputs(m: tfm.ModelConfig, batch: int, seq: int, step: int,
                device) -> dict:
    """The frontend stub's inputs of one step, drawn from a generator
    seeded by the step: whisper's frames [batch, seq, D], internvl2's
    patch embeddings [batch, n_vision_patches, D]; none otherwise."""
    if m.frontend == "audio_stub":
        shape = (batch, seq, m.d_model)
        key = "frames"
    elif m.frontend == "vision_stub":
        shape = (batch, m.n_vision_patches, m.d_model)
        key = "vision_embeds"
    else:
        return {}
    return {key: layers.normal(tfm.generator(step, device), shape, device)}


def main(argv=None) -> dict:
    """Runs the training loop; returns {"start": first step, "losses":
    [loss of each step run], "step_s": [host seconds of each step],
    "launches": this process's kernel launches over the steps}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.host_mesh:
        backend = args.dist_backend or meshlib.default_backend(device)
        meshlib.init_process_group(backend,
                                   cuda_gloo=device.type == "cuda")
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        mesh = meshlib.make_host_mesh(args.model_parallel, device)
    lead = meshlib.rank() == 0

    def say(msg):
        if lead:
            print(msg, flush=True)
    with shlib.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext():
        out = _run(args, device, mesh, say)
    if args.losses_out:
        r = meshlib.rank()
        with open(args.losses_out + (f".rank{r}" if r else ""), "w") as f:
            json.dump(out, f)
    if mesh is not None:
        meshlib.destroy()
    return out


def _run(args, device, mesh, say) -> dict:
    arch = get_arch(args.arch, smoke=args.smoke)
    m = arch.model
    if args.kan_backend:
        m = dataclasses.replace(m, kan_backend=args.kan_backend)

    opt = make_optimizer(arch.optimizer,
                         warmup_cosine(arch.learning_rate, 10, args.steps))
    tcfg = TrainConfig(accum_steps=1, grad_dtype=arch.grad_dtype)
    step_fn = make_train_step(m, opt, tcfg)

    n_model = args.model_parallel if mesh is not None else 1
    params = tfm.init_model(0, m, device=device, n_model=n_model)
    if mesh is not None:
        params = shlib.distribute_tree(params, mesh, tfm.param_spec(m))
    opt_state = opt.init(params)
    dcfg = lm_synth.LMDataConfig(vocab=m.vocab, batch=args.batch,
                                 seq_len=args.seq)
    start = 0

    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        template = (params, opt_state)
        (params, opt_state), extra = ckpt.restore(
            args.ckpt_dir, template, shardings=shlib.shardings_of(template))
        start = extra.get("step", 0)
        say(f"resumed from step {start}")
        if args.verify_restore:
            n = ckpt.verify(args.ckpt_dir, (params, opt_state), start)
            say(f"restored {n} leaves bitwise equal to step {start}'s "
                f"files")

    pre = fault.PreemptionHandler()
    mon = fault.StepMonitor()
    pending_save = None
    losses, step_s = [], []
    ops.reset_launch_counts()
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        mon.start_step(step)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in lm_synth.batch_at(dcfg, step).items()}
        batch.update(stub_inputs(m, args.batch, args.seq, step, device))
        params, opt_state, metrics = step_fn(params, opt_state,
                                             place_batch(batch, mesh))
        losses.append(metrics["loss"])
        inc = mon.end_step()
        if inc:
            say(f"[straggler] step {inc.step}: {inc.duration:.2f}s vs "
                f"median {inc.median:.2f}s")
        if step % args.log_every == 0:
            say(f"step {step}: loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f}")
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = ckpt.save_async(
                args.ckpt_dir, step + 1, (params, opt_state),
                extra={"step": step + 1})
        step_s.append(time.perf_counter() - t0)
        if pre.should_stop:
            say("preemption signal: checkpointing and exiting")
            if args.ckpt_dir:
                ckpt.save(args.ckpt_dir, step + 1, (params, opt_state),
                          extra={"step": step + 1})
            break
    else:
        if args.ckpt_dir:
            if pending_save is not None:
                pending_save.join()
            ckpt.save(args.ckpt_dir, args.steps, (params, opt_state),
                      extra={"step": args.steps})
    if pending_save is not None:
        pending_save.join()
    pre.uninstall()
    say("done")
    return {"start": start, "losses": [float(v) for v in losses],
            "step_s": step_s, "launches": ops.launch_counts()}


if __name__ == "__main__":
    main()

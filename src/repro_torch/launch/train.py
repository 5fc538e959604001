"""Training launcher (port of ``repro.launch.train``): restart-safe and
preemption-aware, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \
        --smoke --steps 12 --batch 4 --seq 64 --ckpt-dir /tmp/ck \
        --save-every 5 --device cpu

Without ``--device`` it runs on the card and raises if there is none.

Fault-tolerance behaviour (the reference's):
  * resumes from the latest complete checkpoint in --ckpt-dir (params,
    optimizer state and the step, which indexes the data stream),
  * SIGTERM/SIGINT trigger a final synchronous checkpoint, then exit 0,
  * an async checkpoint every --save-every steps,
  * straggler incidents (a step over 2.5x the rolling median) are logged.

The batches are ``lm_synth.batch_at(step)``; whisper's frames and
internvl2's patch embeddings are drawn from a ``torch.Generator`` seeded
by the step. ``--host-mesh`` and ``--model-parallel > 1`` are accepted for
the reference's command lines and raise, naming the ROADMAP slice that
brings them.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.data import lm_synth
from repro_torch.dist import fault
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train.train_step import TrainConfig, make_train_step

MESH_SLICE = "ROADMAP Slice F (distribution)"


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
    return ap.parse_args(argv)


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
    [loss of each step run], "step_s": [host seconds of each step]}."""
    args = parse_args(argv)
    if args.host_mesh or args.model_parallel > 1:
        raise NotImplementedError(
            f"--host-mesh and --model-parallel > 1 are not ported yet: "
            f"{MESH_SLICE}")
    device = resolve_device(args.device)
    arch = get_arch(args.arch, smoke=args.smoke)
    m = arch.model
    if args.kan_backend:
        m = dataclasses.replace(m, kan_backend=args.kan_backend)

    opt = make_optimizer(arch.optimizer,
                         warmup_cosine(arch.learning_rate, 10, args.steps))
    tcfg = TrainConfig(accum_steps=1, grad_dtype=arch.grad_dtype)
    step_fn = make_train_step(m, opt, tcfg)

    params = tfm.init_model(0, m, device=device)
    opt_state = opt.init(params)
    dcfg = lm_synth.LMDataConfig(vocab=m.vocab, batch=args.batch,
                                 seq_len=args.seq)
    start = 0

    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), extra = ckpt.restore(
            args.ckpt_dir, (params, opt_state))
        start = extra.get("step", 0)
        print(f"resumed from step {start}", flush=True)

    pre = fault.PreemptionHandler()
    mon = fault.StepMonitor()
    pending_save = None
    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        mon.start_step(step)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in lm_synth.batch_at(dcfg, step).items()}
        batch.update(stub_inputs(m, args.batch, args.seq, step, device))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(metrics["loss"])
        inc = mon.end_step()
        if inc:
            print(f"[straggler] step {inc.step}: {inc.duration:.2f}s vs "
                  f"median {inc.median:.2f}s", flush=True)
        if step % args.log_every == 0:
            print(f"step {step}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = ckpt.save_async(
                args.ckpt_dir, step + 1, (params, opt_state),
                extra={"step": step + 1})
        step_s.append(time.perf_counter() - t0)
        if pre.should_stop:
            print("preemption signal: checkpointing and exiting",
                  flush=True)
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
    print("done", flush=True)
    return {"start": start, "losses": [float(v) for v in losses],
            "step_s": step_s}


if __name__ == "__main__":
    main()

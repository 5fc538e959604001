"""Multi-pod dry run on fake ranks and meta tensors (port of
``repro.launch.dryrun``): build and run every (arch x shape x mesh) cell
once, without hardware and without allocating.

Where the reference lowers and compiles each cell for 512 XLA host
devices, the twin makes this process rank 0 of a world of 256 (``16x16``)
or 512 (``2x16x16``) ranks on torch's fake process group (backend
``"fake"``: every collective returns at once), builds params, optimizer
state, batch and caches as meta tensors placed by the logical rules
(``dist.sharding``; DTensors whose local shards are rank 0's), and runs
the cell's train step, prefill or decode step once under the mesh. Meta
tensors carry shapes only; the four kernels' wrappers take their
shape-only stand-ins (``kernels.shape_ops``). Sharding mismatches,
non-divisible dims and unsupported collectives fail here, as the
reference's compile does.

Each record has the reference's keys where the meaning is the same:
``arch``, ``shape``, ``mesh``, ``devices``, ``smoke``, ``ok``, ``flops``
and ``bytes_accessed`` (rank 0's, from ``analysis.FlopCounter``: FLOPs of
its shards, bytes read and written per eager op), ``collective_bytes``
(input bytes by kind, as the reference sums operand bytes) and ``memory``
(rank 0's bytes of params, optimizer state, batch and cache, read from the
local shards, and ``peak_bytes``: those plus the peak of the step's live
op outputs on rank 0, ``analysis.LiveBytes``). ``collective_traffic`` is
rank 0's bytes moved by the ring model (``analysis.collective_traffic``)
and ``run_s`` the host seconds of the step.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod]
  python -m repro_torch.launch.dryrun --arch mamba2_1p3b --shape \\
      decode_32k --smoke --mesh 4x2

Records go to ``results/dryrun_torch/`` (``--out DIR`` elsewhere). The
fake group is the process's: one process runs one world size at a time.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import configs as cfglib
from repro_torch.analysis import CollectiveBytes, FlopCounter, LiveBytes
from repro_torch.configs import ArchConfig, SHAPES, ShapeSpec, get_arch
from repro_torch.dist import sharding as shlib
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.serve import decode as serve_dec
from repro_torch.train.train_step import TrainConfig, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")
META = torch.device("meta")


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake group of ``n`` ranks (replacing
    a fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(dims: Tuple[int, ...]):
    """A (data, model) or (pod, data, model) mesh over the fake world."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for d in dims:
        n *= d
    fake_world(n)
    axes = ("pod", "data", "model")[-len(dims):]
    return init_device_mesh("cpu", dims, mesh_dim_names=axes)


def _parse_mesh(spec: str) -> Tuple[int, ...]:
    """"4x2" -> (data 4, model 2); "2x4x2" -> (pod, data, model)."""
    dims = tuple(int(d) for d in spec.lower().split("x"))
    if len(dims) not in (2, 3):
        raise SystemExit(f"--mesh {spec!r}: expected DxM (data x model) or "
                         "PxDxM (pod x data x model)")
    return dims


def _placed(shape, dtype, mesh, names):
    """A meta tensor of ``shape`` as a DTensor placed by ``names``."""
    full = torch.empty(shape, dtype=dtype, device=META)
    return shlib.local_to_dtensor(
        full, mesh, shlib.named_sharding(mesh, shape, names).placements)


def batch_tensors(arch: ArchConfig, shape: ShapeSpec, mesh) -> Dict:
    """Meta stand-ins of every model input of this cell, placed."""
    m = arch.model
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": _placed((b, 1), i32, mesh, ("batch", None))}
    batch = {"tokens": _placed((b, s), i32, mesh, ("batch", "seq"))}
    if shape.kind == "train":
        batch["labels"] = _placed((b, s), i32, mesh, ("batch", "seq"))
    if m.frontend == "audio_stub":
        batch["frames"] = _placed((b, s, m.d_model), m.dtype, mesh,
                                  ("batch", "seq", None))
    if m.frontend == "vision_stub":
        batch["vision_embeds"] = _placed((b, m.n_vision_patches, m.d_model),
                                         m.dtype, mesh,
                                         ("batch", "seq", None))
    return batch


def build_cell(arch: ArchConfig, shape: ShapeSpec, mesh):
    """(fn, args, trees): ``fn(*args)`` runs the cell's step once;
    ``trees`` holds its placed params, opt state, batch and cache (those
    it has) for the byte counts and the tests."""
    m = arch.model
    if m.family == "cfkan":
        return _build_cfkan_cell(m.name, shape, mesh)
    n_model = shlib.mesh_sizes(mesh).get("model", 1)
    params = tfm.init_model(0, m, device=META, n_model=n_model)
    has_kan = any(sp.ffn == "kan" for sp in m.layer_specs())
    if shape.kind in ("prefill", "decode") and has_kan:
        # serving runs the frozen artifact, deployed once and replicated
        # (the reference's dry run replicates the whole deployed tree)
        params = shlib.replicate_tree(tfm.deploy_kan(params, m), mesh)
    else:
        params = shlib.distribute_tree(params, mesh, tfm.param_spec(m))
    batch = batch_tensors(arch, shape, mesh)
    trees: Dict[str, Any] = {"params": params, "batch": batch}

    if shape.kind == "train":
        opt = make_optimizer(arch.optimizer,
                             warmup_cosine(arch.learning_rate, 100, 10000))
        # each microbatch must still divide the data-parallel shards
        sizes = shlib.mesh_sizes(mesh)
        dp = sizes.get("pod", 1) * sizes.get("data", 1)
        accum = max(1, min(arch.accum_steps, shape.global_batch // dp))
        step_fn = make_train_step(
            m, opt, TrainConfig(accum_steps=accum, grad_dtype=arch.grad_dtype))
        opt_state = opt.init(params)
        trees["opt_state"] = opt_state
        return step_fn, (params, opt_state, batch), trees

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            with torch.no_grad():
                return serve_dec.prefill(params, m, batch,
                                         max_len=shape.seq_len,
                                         last_only=True)
        return prefill_fn, (params, batch), trees

    enc_len = shape.seq_len if m.family == "encdec" else 0
    cache = serve_dec.init_cache(m, shape.global_batch, shape.seq_len,
                                 device=META, enc_len=enc_len)
    cache = shlib.distribute_tree(cache, mesh, serve_dec.cache_spec(m))
    trees["cache"] = cache

    def decode_fn(params, cache, tokens, index):
        with torch.no_grad():
            return serve_dec.decode_step(params, cache, tokens, index, m)
    # the token at the cache's last position
    return decode_fn, (params, cache, batch["tokens"],
                       shape.seq_len - 1), trees


def _build_cfkan_cell(name: str, shape: ShapeSpec, mesh):
    """The paper's own architecture at full scale (39M/63M 8-bit params):
    the CF-KAN QAT train step, sharded batch x model over the mesh."""
    from repro_torch.models import cf_kan
    mcfg = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_")).MODEL
    pspec = {
        "enc": {"coeffs": ("none", "none", "mlp"), "w_base": ("none", "mlp")},
        "dec": {"coeffs": ("mlp", "none", "embed"),
                "w_base": ("mlp", "embed")},
    }
    params = shlib.distribute_tree(cf_kan.init(0, mcfg, device=META), mesh,
                                   pspec)
    b = max(shape.global_batch, 256)
    x = _placed((b, mcfg.n_items), torch.float32, mesh, ("batch", None))

    def train_step(params, x):
        leaves = {k: {n: t.detach().requires_grad_() for n, t in v.items()}
                  for k, v in params.items()}
        loss = cf_kan.multinomial_loss(leaves, x, mcfg, qat=True)
        flat = [t for v in leaves.values() for t in v.values()]
        grads = iter(torch.autograd.grad(loss, flat))
        new = {k: {n: t.detach() - 1e-3 * next(grads)
                   for n, t in v.items()} for k, v in leaves.items()}
        return new, loss.detach()

    return train_step, (params, x), {"params": params, "batch": {"x": x}}


def _leaves(tree):
    """Tensor leaves of nested dicts, lists, tuples and dataclasses (the
    optimizer's QTensor moments, a deployed KAN artifact)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return []


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf of ``tree``."""
    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if shlib.is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def run_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, smoke: bool = False, mesh_spec: str = "",
             out_dir: str = RESULTS_DIR) -> Dict[str, Any]:
    """One cell: its record (written to ``out_dir`` with ``save``)."""
    arch = get_arch(arch_name, smoke=smoke)
    shape = SHAPES[shape_name]
    if mesh_spec:
        dims, mesh_tag = _parse_mesh(mesh_spec), mesh_spec
    else:
        dims = (2, 16, 16) if multi_pod else (16, 16)
        mesh_tag = "2x16x16" if multi_pod else "16x16"
    n_dev = 1
    for d in dims:
        n_dev *= d
    rec: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                           "mesh": mesh_tag, "devices": n_dev}
    if smoke:   # reduced config: keep these rows out of production records
        rec["smoke"] = True
    t0 = time.time()
    try:
        mesh = make_mesh(dims)
        with shlib.use_mesh(mesh):
            fn, args, trees = build_cell(arch, shape, mesh)
            t1 = time.time()
            cb, fc, lb = CollectiveBytes(), FlopCounter(), LiveBytes()
            with lb, cb, fc:
                fn(*args)
            t2 = time.time()
        held = {f"{name}_bytes": local_bytes(trees.get(key)) for name, key
                in (("param", "params"), ("opt_state", "opt_state"),
                    ("batch", "batch"), ("cache", "cache"))}
        rec.update({
            "ok": True,
            "build_s": round(t1 - t0, 2),
            "run_s": round(t2 - t1, 2),
            "flops": float(fc.flops),
            "bytes_accessed": float(fc.bytes_accessed),
            "collective_bytes": cb.input_bytes_by_kind(),
            "collective_calls": dict(cb.calls),
            "collective_traffic": cb.traffic(),
            "memory": {**held,
                       "peak_bytes": sum(held.values()) + lb.peak},
        })
    except Exception as e:
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-3000:]})
    if save:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{mesh_tag}__smoke" if smoke else mesh_tag
        path = os.path.join(out_dir, f"{arch_name}__{shape_name}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU CI cell)")
    ap.add_argument("--mesh", default="",
                    help="override mesh, e.g. 4x2 (data x model) or 2x4x2 "
                         "(pod x data x model)")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the records")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a, s, ok in cfglib.lm_cells() if ok]
    else:
        cells = [(args.arch, args.shape)]
    recs = []
    for a, s in cells:
        rec = run_cell(a, s, args.multi_pod, smoke=args.smoke,
                       mesh_spec=args.mesh, out_dir=args.out)
        recs.append(rec)
        status = "OK" if rec.get("ok") else f"FAIL {rec.get('error')}"
        mem = rec.get("memory", {})
        print(f"[{rec['mesh']}] {a} x {s}: {status} "
              f"run={rec.get('run_s', 0)}s "
              f"flops={rec.get('flops', 0):.3g} "
              f"perdev~{mem.get('peak_bytes', 0) / 2**30:.2f}GiB "
              f"coll={rec.get('collective_bytes', {})}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return recs


if __name__ == "__main__":
    main()

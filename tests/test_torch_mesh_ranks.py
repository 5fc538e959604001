"""Rank bodies for the port's multi-process mesh tests (no tests here).

``run_ranks(name, world, tmp_path, inputs)`` starts ``world`` Python
processes, each one rank of a gloo process group that meets through a
``FileStore`` in ``tmp_path`` (no fixed port: several pytest workers run
at once). Each child imports this module (never JAX), runs ``CASES[name]``
on the pickled numpy ``inputs`` with one intra-op thread, and pickles what
it returns; ``run_ranks`` returns those results in rank order. The JAX
references run only in the parent test.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")


def run_ranks(name: str, world: int, tmp_path, inputs: dict,
              timeout: float = 600) -> list:
    tmp = str(tmp_path)
    inp = os.path.join(tmp, f"{name}.in.pkl")
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   REPRO_TORCH_STORE=os.path.join(tmp, f"{name}.store"),
                   PYTHONPATH=os.pathsep.join(
                       [SRC, HERE, os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import test_torch_mesh_ranks as m; m._child()", name, inp,
             os.path.join(tmp, f"{name}.out.{r}.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        r = bad[0][0]
        raise RuntimeError(f"rank {r} of {name} failed:\n{logs[r][-6000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{name}.out.{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child() -> None:
    name, inp, outp = sys.argv[1:4]
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshlib
    meshlib.init_process_group("gloo")
    with open(inp, "rb") as f:
        inputs = pickle.load(f)
    result = CASES[name](inputs)
    with open(outp, "wb") as f:
        pickle.dump(result, f)
    meshlib.destroy()


# --- helpers -----------------------------------------------------------------

def _np(t):
    from repro_torch.dist.sharding import is_dtensor
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _place(t, mesh, names):
    from repro_torch.dist import sharding as sh
    return sh.local_to_dtensor(
        t, mesh, sh.named_sharding(mesh, t.shape, names).placements)


def _tree_np(tree):
    from repro_torch.models import transformer as tfm
    return [_np(x) for x in tfm.tree_leaves(tree)]


def _paths_np(tree):
    """Leaf path (the checkpoint's keys, JAX's key paths) -> array."""
    from repro_torch.checkpoint import checkpoint as ckpt
    return {k: _np(v) for k, v in ckpt._leaf_paths(tree).items()}


# --- cases -------------------------------------------------------------------

def psum_case(inp):
    """Each rank's gradient row through ``psum_int8_error_feedback`` over
    the whole world; also its own ``compress_leaf`` codes."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import compress
    r = dist.get_rank()
    g = torch.from_numpy(inp["grads"][r])
    ef = torch.zeros(g.numel())
    out, new_ef = compress.psum_int8_error_feedback({"w": g}, {"w": ef})
    codes, scale, _, _ = compress.compress_leaf(g, ef)
    return {"out": out["w"].numpy(), "ef": new_ef["w"].numpy(),
            "codes": codes.numpy(), "scale": scale.numpy()}


def placement_case(inp):
    """This rank's coordinate and its rows of a ("batch", None) tensor on a
    (pod 2, data 2, model 1) mesh."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    x = torch.from_numpy(inp["x"])
    d = _place(x, mesh, ("batch", None))
    return {"coord": tuple(mesh.get_coordinate()),
            "local": d.to_local().numpy(),
            "placements": [str(p) for p in d.placements]}


def kernels_case(inp):
    """``kan_spline_fused`` and ``ssd`` on a 2x2 mesh (inputs placed as the
    model places them) and unsharded on this rank: outputs and gradients
    against fixed output weights."""
    import torch
    from repro_torch.core.quant import ASPConfig
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    mesh = meshlib.make_host_mesh(2, "cpu")
    asp = ASPConfig(grid_size=8, order=3)
    res = {}
    x = torch.from_numpy(inp["kan_x"])
    for which, names in (("up", ("embed", "none", "mlp")),
                         ("down", ("mlp", "none", "embed"))):
        c = torch.from_numpy(inp[f"kan_{which}"])
        w = torch.from_numpy(inp[f"kan_{which}_w"])
        xin = x if which == "up" else torch.from_numpy(inp["kan_h"])
        a, b = xin.clone().requires_grad_(), c.clone().requires_grad_()
        y0 = ops.kan_spline_fused(a, b, asp)
        g0 = torch.autograd.grad((y0 * w).sum(), (a, b))
        with sh.use_mesh(mesh):
            da = _place(xin, mesh, ("batch", "seq", None)).requires_grad_()
            db = _place(c, mesh, names).requires_grad_()
            y1 = ops.kan_spline_fused(da, db, asp)
            g1 = torch.autograd.grad((y1 * w).sum(), (da, db))
        res[which] = {"y": (_np(y0), _np(y1)),
                      "dx": (_np(g0[0]), _np(g1[0])),
                      "dc": (_np(g0[1]), _np(g1[1])),
                      "coeff_placements": [str(p) for p in db.placements]}
    ins = [torch.from_numpy(inp[k]) for k in ("x", "dt", "a", "b", "c", "d")]
    names = (("batch", "seq", "heads", None), ("batch", "seq", "heads"),
             ("heads",), ("batch", "seq", None), ("batch", "seq", None),
             ("heads",))
    w = torch.from_numpy(inp["ssd_w"])
    plain = [t.clone().requires_grad_() for t in ins]
    y0 = ops.ssd(*plain, chunk=8)
    g0 = torch.autograd.grad((y0 * w).sum(), plain)
    with sh.use_mesh(mesh):
        dts = [_place(t, mesh, n).requires_grad_()
               for t, n in zip(ins, names)]
        y1 = ops.ssd(*dts, chunk=8)
        g1 = torch.autograd.grad((y1 * w).sum(), dts)
    res["ssd"] = {"y": (_np(y0), _np(y1)),
                  "grads": [(_np(a), _np(b)) for a, b in zip(g0, g1)]}
    return res


def moe_case(inp):
    """Both sharded ``apply_moe`` paths on a 2x2 mesh with JAX's packed
    parameters: outputs, aux losses and (expert-parallel) gradients."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe as moe_lib
    mesh = meshlib.make_host_mesh(2, "cpu")
    cfg = moe_lib.MoEConfig(**inp["cfg"])
    spec = moe_lib.moe_spec(cfg)
    x = torch.from_numpy(inp["x"])
    w = torch.from_numpy(inp["w"])
    res = {}
    with sh.use_mesh(mesh):
        params = sh.distribute_tree(
            {k: torch.from_numpy(v) for k, v in inp["params"].items()},
            mesh, spec)
        params = {k: v.requires_grad_() for k, v in params.items()}
        dx = _place(x, mesh, ("batch", "seq", None)).requires_grad_()
        y, aux = moe_lib.apply_moe(params, dx, cfg)
        loss = (y * w).sum() + aux["moe_load_balance"] + aux["moe_z"]
        keys = sorted(params)
        grads = torch.autograd.grad(loss, [dx] + [params[k] for k in keys])
        res["ep"] = {"y": _np(y), "aux": {k: _np(v) for k, v in aux.items()},
                     "grads": dict(zip(["x"] + keys,
                                       [_np(g) for g in grads]))}
        with torch.no_grad():
            y, aux = moe_lib.apply_moe(params, dx, cfg,
                                       weights_stationary=True)
        res["ws"] = {"y": _np(y), "aux": {k: _np(v) for k, v in aux.items()}}
    return res


def train_case(inp):
    """``train_one`` for each of ``inp["archs"]``, by arch id."""
    return {a["arch"]: train_one(a) for a in inp["archs"]}


def train_one(inp):
    """One train step of an arch's SMOKE config on a (data, model) mesh and
    unsharded, from the same parameters (carried from numpy when given):
    loss, grad norm, the gradients and every updated leaf from each."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.train import place_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              value_and_grad)
    arch = get_arch(inp["arch"], smoke=not inp.get("full"))
    m = arch.model
    if inp.get("kan_backend"):
        m = dataclasses.replace(m, kan_backend=inp["kan_backend"])
    mesh = meshlib.make_host_mesh(inp["model"], "cpu")
    opt = make_optimizer(arch.optimizer, warmup_cosine(1e-2, 2, 10))
    step = make_train_step(m, opt, TrainConfig())
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    if "params" in inp:
        params = tfm.params_from_numpy(inp["params"], device="cpu")
    else:
        params = tfm.init_model(0, m, device="cpu", n_model=inp["model"])
    res = {}
    if inp.get("unsharded", True):
        g0 = value_and_grad(tfm.loss_fn, params, m, batch)[2]
        p0, _, met0 = step(params, opt.init(params), batch)
        res["plain"] = {"loss": float(met0["loss"]),
                        "gnorm": float(met0["grad_norm"]),
                        "grads": _paths_np(g0), "leaves": _paths_np(p0)}
    with sh.use_mesh(mesh):
        dp = sh.distribute_tree(params, mesh, tfm.param_spec(m))
        db = place_batch(batch, mesh)
        g1 = value_and_grad(tfm.loss_fn, dp, m, db)[2]
        p1, _, met1 = step(dp, opt.init(dp), db)
        res["mesh"] = {"loss": float(met1["loss"]),
                       "gnorm": float(met1["grad_norm"]),
                       "grads": _paths_np(g1), "leaves": _paths_np(p1)}
    return res


def ckpt_save_case(inp):
    """Save kan_llm SMOKE parameters and AdamW state from a 2x2 mesh."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import make_optimizer, warmup_cosine
    m = get_arch("kan_llm", smoke=True).model
    mesh = meshlib.make_host_mesh(2, "cpu")
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 2, 10))
    with sh.use_mesh(mesh):
        params = sh.distribute_tree(tfm.init_model(3, m, device="cpu"),
                                    mesh, tfm.param_spec(m))
        state = opt.init(params)
        # moments that are not zeros
        state["m"] = tfm.tree_map(lambda t: t + torch.full_like(t, 0.25),
                                  state["m"])
        ckpt.save(inp["dir"], 5, (params, state), extra={"step": 5})
    return {"leaves": _tree_np((params, state["m"], state["v"]))}


def ckpt_restore_case(inp):
    """Restore that checkpoint onto a 1x2 mesh with ``shardings=``."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import make_optimizer, warmup_cosine
    m = get_arch("kan_llm", smoke=True).model
    mesh = meshlib.make_host_mesh(2, "cpu")
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 2, 10))
    with sh.use_mesh(mesh):
        params = sh.distribute_tree(tfm.init_model(0, m, device="cpu"),
                                    mesh, tfm.param_spec(m))
        state = opt.init(params)
        pshard = sh.tree_shardings(mesh, params, tfm.param_spec(m))
        (params, state), extra = ckpt.restore(
            inp["dir"], (params, state),
            shardings=(pshard, sh.shardings_of(state)))
    return {"step": extra["step"],
            "leaves": _tree_np((params, state["m"], state["v"])),
            "placements": [[str(p) for p in t.placements]
                           for t in tfm.tree_leaves(params)],
            "local_shapes": [tuple(t.to_local().shape)
                             for t in tfm.tree_leaves(params)]}


def serve_case(inp):
    """Per served config on a (2, 2) mesh: the completion tokens of an
    ``Engine`` over the given params and trace, the local shapes of its
    cache leaves (by key path), whether a mesh was left current, and the
    tokens of ``launch.serve --mesh-model 2`` on the given command line."""
    import dataclasses
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import engine as eng_lib
    runs = []
    run = eng_lib.Engine.run

    def spy(self, *args, **kw):
        comps = run(self, *args, **kw)
        runs.append(comps)
        return comps
    eng_lib.Engine.run = spy
    mesh = meshlib.make_host_mesh(2, "cpu")
    out = {}
    for key, c in inp["configs"].items():
        m = dataclasses.replace(get_arch(c["arch"], smoke=True).model,
                                **c["over"])
        params = tfm.params_from_numpy(c["params"], device="cpu")
        with sh.use_mesh(mesh):
            eng = eng_lib.Engine(params, m, **inp["eng_kw"])
            comps = eng.run(eng_lib.synth_trace(m.vocab, **inp["trace"]))
        shapes = {k: tuple(v.to_local().shape)
                  for k, v in ckpt._leaf_paths(eng.cache).items()}
        leaked = sh.current_mesh() is not None
        runs.clear()
        launch.main(c["argv"] + ["--mesh-model", "2", "--device", "cpu"])
        served = {x.rid: [int(t) for t in x.tokens]
                  for r in runs for x in r if x.rid != "probe"}
        out[key] = {"engine": {x.rid: [int(t) for t in x.tokens]
                               for x in comps},
                    "shapes": shapes, "leaked": leaked, "launcher": served}
    return out


def launch_serve_case(inp):
    """``launch.serve.main`` on this rank; its report."""
    from repro_torch.launch import serve as launch
    return launch.main(inp["argv"])


CASES = {
    "psum": psum_case, "placement": placement_case,
    "kernels": kernels_case, "moe": moe_case, "train": train_case,
    "ckpt_save": ckpt_save_case, "ckpt_restore": ckpt_restore_case,
    "serve": serve_case, "launch_serve": launch_serve_case,
}

if __name__ == "__main__":
    raise SystemExit("a helper module: run_ranks starts its rank bodies")

"""The dry-run twin (``repro_torch.launch.dryrun``) against the reference's
``repro.launch.dryrun``.

The reference's seven ``ARCHS`` x {train, decode} cells
(``tests/test_dryrun.py``: SMOKE configs, accumulation 2, a (pod 2, data
2, model 2) mesh) run on torch's fake group of 8 ranks with meta tensors,
in two processes of their own (the fake group is the process's): every
cell runs its step once, ``ok``, with FLOPs counted on rank 0's shards.
Each parameter leaf's (and, for decode, cache leaf's) shard on rank 0 has
the shape JAX's ``NamedSharding.shard_shape`` gives for the same spec on
the same mesh, taken live from the reference's ``build_cell`` (its
``jax.eval_shape`` stand-ins; nothing is lowered or compiled), in a JAX
process on 8 forced host devices. The reference's CI cell runs through
the CLI, its record written to a temporary directory.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_mesh_ranks import SRC  # noqa: E402

ARCHS = ["whisper_base", "recurrentgemma_2b", "kimi_k2_1t_a32b",
         "mixtral_8x7b", "qwen2_72b", "mamba2_1p3b", "internvl2_76b"]
KINDS = ["train", "decode"]

PORT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.analysis import FlopCounter
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import dryrun as dr
    kind = sys.argv[1]
    mesh = dr.make_mesh((2, 2, 2))
    shape = {"train": ShapeSpec("t", 64, 8, "train"),
             "decode": ShapeSpec("d", 64, 8, "decode")}[kind]
    out = {}
    for arch_id in json.loads(sys.argv[2]):
        arch = dataclasses.replace(get_arch(arch_id, smoke=True),
                                   accum_steps=2)
        with sh.use_mesh(mesh):
            fn, args, trees = dr.build_cell(arch, shape, mesh)
            fc = FlopCounter()
            with fc:
                fn(*args)
        out[arch_id] = {
            "flops": fc.flops,
            **{name: {k: list(v.to_local().shape) for k, v in
                      ckpt._leaf_paths(trees[name]).items()}
               for name in ("params", "cache") if name in trees}}
    print(json.dumps(out))
""")

JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax
    from repro.configs import ShapeSpec, get_arch
    from repro.launch import dryrun as dr
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)

    def shards(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path):
                list(leaf.sharding.shard_shape(leaf.shape))
                for path, leaf in leaves}
    out = {}
    for arch_id in json.loads(sys.argv[1]):
        arch = dataclasses.replace(get_arch(arch_id, smoke=True),
                                   accum_steps=2)
        for kind in ("train", "decode"):
            shape = {"train": ShapeSpec("t", 64, 8, "train"),
                     "decode": ShapeSpec("d", 64, 8, "decode")}[kind]
            with mesh:
                fn, args = dr.build_cell(arch, shape, mesh)
            cell = {"params": shards(args[0])}
            if kind == "decode":
                cell["cache"] = shards(args[1])
            out[f"{arch_id}/{kind}"] = cell
    print(json.dumps(out))
""")


def _start(script, *args, jax=False):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, timeout=900):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    """The port's 14 cells (train and decode in parallel processes) and
    the reference's shard shapes, per ``arch/kind``."""
    pytest.importorskip("jax")
    procs = {kind: _start(PORT, kind, json.dumps(ARCHS)) for kind in KINDS}
    ref = _result(_start(JAX, json.dumps(ARCHS), jax=True))
    port = {}
    for kind, proc in procs.items():
        for arch_id, cell in _result(proc).items():
            port[f"{arch_id}/{kind}"] = cell
    return port, ref


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_dryrun_cell_multipod_smoke(cells, arch_id, kind):
    port, ref = cells
    got, want = port[f"{arch_id}/{kind}"], ref[f"{arch_id}/{kind}"]
    assert got["flops"] > 0
    assert got["params"] == want["params"]
    if kind == "decode":
        assert got["cache"] == want["cache"]


def test_ci_cell_through_the_cli(tmp_path):
    """``--arch mamba2_1p3b --shape decode_32k --smoke --mesh 4x2``: an
    ``ok`` record with the reference's keys, rank 0's bytes and traffic."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2_1p3b", "--shape", "decode_32k", "--smoke", "--mesh", "4x2",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[4x2] mamba2_1p3b x decode_32k: OK" in out.stdout
    rec = json.loads((tmp_path / "mamba2_1p3b__decode_32k__4x2__smoke.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "devices", "smoke", "ok", "flops",
                "bytes_accessed", "collective_bytes", "memory"):
        assert key in rec, key
    assert rec["ok"] and rec["devices"] == 8 and rec["smoke"]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    mem = rec["memory"]
    assert mem["param_bytes"] > 0 and mem["cache_bytes"] > 0
    assert mem["batch_bytes"] > 0 and mem["opt_state_bytes"] == 0
    assert mem["peak_bytes"] is None or mem["peak_bytes"] > 0
    assert rec["collective_traffic"]["total"] == pytest.approx(
        sum(v for k, v in rec["collective_traffic"].items() if k != "total"))

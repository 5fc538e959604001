"""Serving under a mesh (``Engine`` and ``launch.serve --mesh-model``)
against one process of the port and against the JAX engine.

Four gloo ranks on the CPU form a (data 2, model 2) mesh
(``test_torch_mesh_ranks.run_ranks``, its ``serve`` body). For each served
family at its SMOKE config (here mistral-nemo-12b for attention,
mamba2-1.3b for SSD and ``kan_llm`` deployed on ``fused``;
``test_torch_serve_mesh_kan.py`` the other KAN backends, through the
helpers here) they run:

* an ``Engine`` over JAX's params (carried across with
  ``params_from_numpy``) on ``test_torch_engine.py``'s trace: every rank's
  tokens are the same, and equal the port's one-process engine's and the
  JAX engine's up to the first near tie (the one-process run's top-1
  logit leading its top-2 by no more than ``F32_LEAD``: a mesh sums some
  products in two halves, so a near tie may break the other way);
* the reference's CI command, ``launch.serve --smoke --check --slots 2
  --requests 6 --stagger 3 --prompt-len 10 --new-tokens 8 --mesh-model
  2``: every rank passes ``--check``, and its tokens equal the launcher's
  in one process, up to the first near tie of the port's own logits;
* each cache leaf's shard on the rank has the shape JAX's
  ``NamedSharding(mesh, spec).shard_shape`` gives for
  ``paged_cache_spec`` on the same (2, 2) mesh (JAX on four forced host
  devices, in a subprocess).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_engine import TRACE  # noqa: E402
from test_torch_mesh_ranks import SRC, run_ranks  # noqa: E402

F32_LEAD = 1e-3
ENG_KW = dict(n_slots=2, max_len=24, page_size=4, n_pages=13)
CI_ARGV = ["--smoke", "--check", "--slots", "2", "--requests", "6",
           "--stagger", "3", "--prompt-len", "10", "--new-tokens", "8"]
CONFIGS = {"attn": ("mistral_nemo_12b", None),
           "ssd": ("mamba2_1p3b", None),
           "kan_fused": ("kan_llm", "fused")}

JAX_SHAPES = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.configs import get_arch
    from repro.dist import sharding as shlib
    from repro.serve import decode as dec
    cfgs, kw = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for key, (arch, backend) in cfgs.items():
        m = get_arch(arch, smoke=True).model
        if backend:
            m = dataclasses.replace(m, kan_backend=backend)
        cache = jax.eval_shape(lambda: dec.init_paged_cache(
            m, kw["n_slots"], kw["max_len"], page_size=kw["page_size"],
            n_pages=kw["n_pages"]))
        shard = shlib.tree_shardings(mesh, cache, dec.paged_cache_spec(m))
        leaves = jax.tree_util.tree_flatten_with_path(cache)[0]
        out[key] = {
            "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): list(s.shard_shape(leaf.shape))
            for (path, leaf), s in zip(leaves, jax.tree.leaves(shard))}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import types
    from repro.configs import get_arch
    from repro.models import transformer
    from repro.serve import decode, engine
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, get_arch=get_arch,
                                 tfm=transformer, dec=decode, eng=engine)


def _jax_model(jx, arch, backend):
    over = {} if backend is None else {"kan_backend": backend}
    return dataclasses.replace(jx.get_arch(arch, smoke=True).model, **over)


def _port_model(arch, backend):
    over = {} if backend is None else {"kan_backend": backend}
    return dataclasses.replace(tconfigs.get_arch(arch, smoke=True).model,
                               **over)


def serve_runs(jx, tmp, configs):
    """The four ranks' results, and per config the JAX engine's and the
    port's one-process engine and launcher tokens (with the deployed
    params and config of each one-process run)."""
    inputs, ref = {}, {}
    for key, (arch, backend) in configs.items():
        jm = _jax_model(jx, arch, backend)
        jp = jx.tfm.init_model(jx.jax.random.PRNGKey(3), jm)
        np_params = jx.jax.tree.map(np.asarray, jp)
        argv = ["--arch", arch] + CI_ARGV + (
            ["--kan-backend", backend] if backend else [])
        inputs[key] = {"arch": arch, "params": np_params, "argv": argv,
                       "over": {} if backend is None
                       else {"kan_backend": backend}}
        jcomps = jx.eng.Engine(jp, jm, **ENG_KW).run(
            jx.eng.synth_trace(jm.vocab, **TRACE))
        tm = _port_model(arch, backend)
        te = teng.Engine(ttfm.params_from_numpy(np_params, device="cpu"), tm,
                         device="cpu", **ENG_KW)
        reqs = teng.synth_trace(tm.vocab, **TRACE)
        tcomps = te.run(reqs)
        ref[key] = {"jax": {c.rid: [int(t) for t in c.tokens]
                            for c in jcomps},
                    "port": {"toks": {c.rid: [int(t) for t in c.tokens]
                                      for c in tcomps},
                             "params": te.params, "cfg": tm,
                             "reqs": reqs},
                    "launcher": _launcher_tokens(argv)}
    ranks = run_ranks("serve", 4, tmp, {"configs": inputs,
                                        "eng_kw": ENG_KW, "trace": TRACE},
                      timeout=900)
    return ranks, ref


@pytest.fixture(scope="module")
def runs(jx, tmp_path_factory):
    return serve_runs(jx, tmp_path_factory.mktemp("serve_mesh"), CONFIGS)


def _launcher_tokens(argv):
    """The one-process launcher's completion tokens (its main engine's
    run, not the EOS probe's), with that engine's deployed params and
    config and the trace the launcher drew."""
    seen = []
    run = teng.Engine.run

    def spy(self, *a, **k):
        comps = run(self, *a, **k)
        seen.append((self, comps))
        return comps
    teng.Engine.run = spy
    try:
        tlaunch.main(argv + ["--device", "cpu"])
    finally:
        teng.Engine.run = run
    eng, comps = seen[-1]
    reqs = teng.synth_trace(eng.cfg.vocab, 6, max_prompt=10, min_prompt=5,
                            max_new=8, min_new=4, stagger=3, seed=0)
    return {"toks": {c.rid: [int(t) for t in c.tokens] for c in comps},
            "params": eng.params, "cfg": eng.cfg, "reqs": reqs}


def _cut(params, m, prompt, toks):
    """The first step where the port's one-process run, teacher-forced on
    ``toks``, has its top-1 logit lead its top-2 by no more than
    ``F32_LEAD``."""
    logits, cache = tdec.prefill(params, m,
                                 {"tokens": torch.as_tensor(prompt)[None]},
                                 max_len=len(prompt) + len(toks),
                                 last_only=True)
    steps = [logits[0, -1]]
    for i in range(len(toks) - 1):
        logits, cache = tdec.decode_step(params, cache,
                                         torch.tensor([[toks[i]]]),
                                         len(prompt) + i, m)
        steps.append(logits[0, 0])
    for i, lg in enumerate(steps):
        top2 = torch.sort(lg.float()).values[-2:]
        if float(top2[1] - top2[0]) <= F32_LEAD:
            return i
    return len(steps)


def check_tokens(got_by_rank, one, *others):
    """Every rank's tokens are rank 0's; they and ``others`` (dicts rid ->
    tokens) equal the one-process run ``one`` up to its first near tie.
    Returns the steps compared."""
    got = got_by_rank[0]
    assert all(g == got for g in got_by_rank[1:]), "ranks disagree"
    assert all(set(o) == set(one["toks"]) for o in (got,) + others)
    compared = 0
    for req in one["reqs"]:
        want = one["toks"][req.rid]
        cut = _cut(one["params"], one["cfg"], np.asarray(req.tokens), want)
        for o in (got,) + others:
            assert o[req.rid][:cut] == want[:cut], (req.rid, cut)
            assert len(o[req.rid]) == len(want)
        compared += cut
    assert compared > 0
    return compared


def check_engine(runs, key):
    ranks, ref = runs
    check_tokens([rk[key]["engine"] for rk in ranks], ref[key]["port"],
                 ref[key]["jax"])


def check_launcher(runs, key):
    ranks, ref = runs
    check_tokens([rk[key]["launcher"] for rk in ranks], ref[key]["launcher"])


def check_shards(runs, jax_shards, key):
    ranks, _ = runs
    want = {k: tuple(v) for k, v in jax_shards[key].items()}
    for rk in ranks:
        assert rk[key]["shapes"] == want
        assert not rk[key]["leaked"]


@pytest.mark.parametrize("key", list(CONFIGS))
def test_engine_on_a_mesh_matches_jax(runs, key):
    check_engine(runs, key)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_launcher_on_a_mesh_matches_one_process(runs, key):
    """The reference's CI command on four ranks: each rank's ``--check``
    held (a failing rank fails ``run_ranks``), and its tokens are the
    one-process launcher's up to the first near tie."""
    check_launcher(runs, key)


def jax_shard_shapes(configs):
    """Per config, JAX's shard shape of every ``paged_cache_spec`` leaf on
    a (2, 2) mesh of forced host devices (a subprocess)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", JAX_SHAPES, json.dumps(configs),
         json.dumps(ENG_KW)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_shards():
    return jax_shard_shapes(CONFIGS)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_cache_shards_match_jax(runs, jax_shards, key):
    check_shards(runs, jax_shards, key)


@pytest.fixture
def world_of_one():
    """This process as a one-rank gloo world, left again afterwards."""
    tmesh.init_process_group("gloo")
    yield
    tmesh.destroy()


def test_engine_keeps_its_mesh_to_itself(world_of_one):
    """An engine built under a mesh refuses an explicit device, runs its
    ticks under its own mesh after the caller's has closed, and a later
    engine without a mesh holds plain tensors on the device it names."""
    m, trace = _port_model("mamba2_1p3b", None), dict(TRACE, n_requests=2)
    params = ttfm.init_model(0, m, device="cpu")
    mesh = tmesh.make_host_mesh(1, "cpu")
    with tsh.use_mesh(mesh):
        with pytest.raises(ValueError, match="mutually exclusive"):
            teng.Engine(params, m, device="cpu", **ENG_KW)
        on_mesh = teng.Engine(params, m, **ENG_KW)
    assert on_mesh.mesh is mesh and on_mesh.device == torch.device("cpu")
    assert all(tsh.is_dtensor(t) for t in ttfm.tree_leaves(on_mesh.cache))
    got = on_mesh.run(teng.synth_trace(m.vocab, **trace))
    assert tsh.current_mesh() is None
    plain = teng.Engine(params, m, device="cpu", **ENG_KW)
    assert plain.mesh is None
    assert not any(tsh.is_dtensor(t) for t in ttfm.tree_leaves(plain.cache))
    want = plain.run(teng.synth_trace(m.vocab, **trace))
    assert [list(c.tokens) for c in got] == [list(c.tokens) for c in want]


def test_model_axis_must_divide_the_world():
    """A one-rank world (no rendezvous in the environment) cannot hold a
    model axis of 2; the launcher leaves the group it joined."""
    with pytest.raises(ValueError, match="does not divide"):
        tlaunch.main(["--arch", "mamba2_1p3b", "--device", "cpu",
                      "--mesh-model", "2"] + CI_ARGV)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("local, cards, want", [
    (None, 1, "nccl"), ("1", 1, "nccl"), ("4", 1, "gloo"), ("4", 4, "nccl"),
    ("8", 4, "gloo")])
def test_backend_follows_the_ranks_per_card(monkeypatch, local, cards, want):
    """The launchers' backend: gloo on the CPU; on the card gloo only when
    a node's ranks (torchrun's ``LOCAL_WORLD_SIZE``) outnumber its cards,
    as NCCL refuses two ranks on one GPU, else NCCL."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert tmesh.default_backend(torch.device("cpu")) == "gloo"
    assert tmesh.default_backend(torch.device("cuda")) == want

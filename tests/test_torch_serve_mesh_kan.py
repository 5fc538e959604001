"""Serving ``kan_llm`` under a mesh on the KAN backends other than
``fused`` (which ``test_torch_serve_mesh.py`` holds with the attention and
SSD families): the same checks through that module's helpers, on four
gloo ranks of a (2, 2) mesh. Every rank holds the whole deployed
artifact; ``kan.apply`` runs each rank's rows through it."""
import pytest

pytest.importorskip("torch")

import test_torch_serve_mesh as sm  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_serve_mesh import jx  # noqa: E402,F401

CONFIGS = {f"kan_{b}": ("kan_llm", b)
           for b in ("lut", "lut_int8", "cim", "cim_tiled", "ref")}


@pytest.fixture(scope="module")
def runs(jx, tmp_path_factory):  # noqa: F811
    return sm.serve_runs(jx, tmp_path_factory.mktemp("serve_mesh_kan"),
                         CONFIGS)


@pytest.fixture(scope="module")
def jax_shards():
    return sm.jax_shard_shapes(CONFIGS)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_engine_on_a_mesh_matches_jax(runs, key):
    sm.check_engine(runs, key)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_launcher_on_a_mesh_matches_one_process(runs, key):
    sm.check_launcher(runs, key)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_cache_shards_match_jax(runs, jax_shards, key):
    sm.check_shards(runs, jax_shards, key)

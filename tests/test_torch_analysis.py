"""``repro_torch.analysis`` against the reference's ``repro.analysis``.

* ``collective_traffic`` on the four ops of the reference's
  ``test_collective_traffic_parser`` (tests/test_dryrun.py), fed as counted
  records (kind, output bytes, group size) instead of HLO text: the
  reference's byte totals, within 1 byte; and equal to the reference's own
  parser on the same ops.
* ``CollectiveBytes`` counts what DTensor issues on torch's fake group:
  one all-gather of a [64, 512] f32 tensor split over 4 ranks records 32
  KiB in, 128 KiB out, a group of 4.
* ``FlopCounter`` counts a sharded matmul's FLOPs on the rank's local
  shapes, and a plain matmul's in full.
* ``obs.profile.roofline_rows`` on a snapshot with gauges returns the
  reference's rows (its ``roofline_terms`` applied to the H100's
  constants: the formula is the reference's, the peaks the card's).
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch import analysis  # noqa: E402
from repro_torch.obs import profile as tprofile  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_mesh_ranks import SRC  # noqa: E402

REF_HLO = """
  %all-gather.6 = f32[8192,8,8]{2,1,0} all-gather(%x), channel_id=29, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %all-reduce.1 = bf16[1024]{0} all-reduce(%y), channel_id=3, replica_groups=[4,64]<=[256], to_apply=%add
  %rs = f32[64]{0} reduce-scatter(%z), channel_id=5, replica_groups=[16,16]<=[256], dimensions={0}
  %ar-done = f32[8]{0} all-reduce-done(%w)
"""
# the same four ops as counted records; an all-reduce-done is not a call
RECORDS = [analysis.Collective("all-gather", 8192 * 8 * 8 * 4, 16),
           analysis.Collective("all-reduce", 1024 * 2, 64),
           analysis.Collective("reduce-scatter", 64 * 4, 16)]


def test_collective_traffic_matches_the_reference_parser_test():
    t = analysis.collective_traffic(RECORDS)
    ag = 8192 * 8 * 8 * 4 * 15 / 16
    ar = 1024 * 2 * 2 * 63 / 64
    rs = 64 * 4 * 15
    assert abs(t["all-gather"] - ag) < 1
    assert abs(t["all-reduce"] - ar) < 1
    assert abs(t["reduce-scatter"] - rs) < 1
    assert t["total"] == pytest.approx(ag + ar + rs)


def test_collective_traffic_equals_the_reference_on_the_same_ops():
    from repro import analysis as ref
    want = ref.collective_traffic(REF_HLO, 256)
    got = analysis.collective_traffic(RECORDS)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1, k


@pytest.mark.parametrize("kind,o,n,moved", [
    ("all-to-all", 4096, 8, 4096 * 7 / 8),
    ("collective-permute", 4096, 8, 4096.0),
    ("all-gather", 100, 1, 0.0)])
def test_collective_traffic_per_kind(kind, o, n, moved):
    t = analysis.collective_traffic([analysis.Collective(kind, o, n)])
    assert t[kind] == pytest.approx(moved)
    assert t["total"] == pytest.approx(moved)


def test_collective_traffic_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective"):
        analysis.collective_traffic([analysis.Collective("gather", 1, 2)])


FAKE = textwrap.dedent("""
    import json, torch
    from repro_torch.analysis import CollectiveBytes, FlopCounter
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import dryrun
    mesh = dryrun.make_mesh((4, 2))
    x = torch.empty(64, 512, device="meta")
    w = torch.empty(512, 1024, device="meta")
    xd = sh.local_to_dtensor(x, mesh, sh.named_sharding(
        mesh, x.shape, ("batch", None)).placements)
    wd = sh.local_to_dtensor(w, mesh, sh.named_sharding(
        mesh, w.shape, (None, "mlp")).placements)
    cb, fc = CollectiveBytes(), FlopCounter()
    with cb, fc:
        y = xd @ wd
        whole = y.full_tensor()
    plain = FlopCounter()
    with plain:
        torch.empty(16, 512, device="meta") @ torch.empty(
            512, 512, device="meta")
    print(json.dumps(dict(
        flops=fc.flops, plain=plain.flops, local=list(y.to_local().shape),
        calls=cb.calls, records=[list(r) for r in cb.records],
        traffic=cb.traffic(), whole=list(whole.shape))))
""")


@pytest.fixture(scope="module")
def fake_run():
    """A matmul on a (4, 2) fake group, in a process of its own (the fake
    group is the process's)."""
    import json
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", FAKE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_matmul_counts_the_local_shapes_flops(fake_run):
    # x's rows split 4 ways, w's columns 2 ways: the rank's product is
    # [16, 512] @ [512, 512]
    assert fake_run["local"] == [16, 512]
    assert fake_run["flops"] == 2 * 16 * 512 * 512
    assert fake_run["plain"] == 2 * 16 * 512 * 512


def test_collectives_are_counted_as_issued(fake_run):
    # full_tensor gathers the [16, 512] shard over both mesh dims
    assert sum(fake_run["calls"].values()) == len(fake_run["records"]) > 0
    assert set(fake_run["calls"]) == {"all_gather_into_tensor"}
    want = analysis.collective_traffic(
        [analysis.Collective(*r) for r in fake_run["records"]])
    assert fake_run["traffic"] == pytest.approx(want)
    assert fake_run["whole"] == [64, 1024]
    out_bytes = sorted(r[1] for r in fake_run["records"])
    groups = sorted(r[2] for r in fake_run["records"])
    assert groups == [2, 4]
    # model axis first (16 x 512 -> 16 x 1024), then data (-> 64 x 1024),
    # or the other way round: the last gather's output is the whole tensor
    assert out_bytes[-1] == 64 * 1024 * 4


def test_roofline_rows_are_the_references():
    from repro import analysis as ref_analysis
    snap = {"metrics": {
        'compiled_flops{fn="decode_tick"}': {"value": 3.0e12},
        'compiled_bytes{fn="decode_tick"}': {"value": 2.0e9},
        'compiled_flops{fn="prefill_len8"}': {"value": 1.0e9},
        'compiled_bytes{fn="prefill_len8"}': {"value": 5.0e10},
        "serve_requests_total": {"value": 3}}}
    rows = tprofile.roofline_rows(snap)
    assert [r["fn"] for r in rows] == ["decode_tick", "prefill_len8"]
    consts = ("PEAK_FLOPS", "HBM_BW", "ICI_BW")
    saved = [getattr(ref_analysis, c) for c in consts]
    try:
        for c, v in zip(consts, (analysis.PEAK_FLOPS, analysis.HBM_BW,
                                 analysis.LINK_BW)):
            setattr(ref_analysis, c, v)
        for r in rows:
            want = ref_analysis.roofline_terms(r["flops"], r["bytes"], 0.0)
            assert {k: r[k] for k in want} == pytest.approx(want)
    finally:
        for c, v in zip(consts, saved):
            setattr(ref_analysis, c, v)
    assert rows[0]["dominant"] == "compute"
    assert rows[1]["dominant"] == "memory"
    assert tprofile.roofline_rows({"metrics": {}}) == []

"""The LM cells' harness on the CPU at the program's SMOKE widths: the
reference against the recurrence and the program's forward, the engine's
tokens against the reference through ``check``'s numbers, the rule that
places a request's first token, the traffic's stream, the result line,
the fp8 control and planted faults failing ``correct``."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from kbtiny import REPO, tiny_root
from kanbench import check, control, lm_run, lm_system, lm_traffic, resolve
from kanbench.reference import mamba2 as ref

CELL = "mamba2.engine.offline.c64"
SEED = 3_000_000_019


@pytest.fixture
def tiny(tmp_path):
    root = tiny_root(tmp_path, "engine.offline.c64", config="mamba2-1.3b")
    return root, resolve.cell(root, "tiny")


def _run(tiny, seconds=0.6, **kw):
    root, cell = tiny
    return lm_run.run(cell, SEED, seconds, kw.pop("traced", False),
                      device="cpu", root=root, **kw)


def _recurrence(x, dt, a, b, c, d_skip):
    """The SSD as the paper's recurrence, one step at a time, float64."""
    x, dt, a, b, c = (t.double() for t in (x, dt, a, b, c))
    t, h, p = x.shape
    state = torch.zeros(h, p, b.shape[1], dtype=torch.float64)
    ys = []
    for i in range(t):
        state = (torch.exp(dt[i] * a)[:, None, None] * state
                 + (dt[i][:, None] * x[i])[..., None] * b[i])
        ys.append(state @ c[i] + d_skip.double()[:, None] * x[i])
    return torch.stack(ys)


def test_reference_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    t, h, p, n = 37, 3, 4, 5
    x = torch.randn(t, h, p, generator=g)
    dt = torch.rand(t, h, generator=g) * 2
    a = -torch.rand(h, generator=g) - 0.1
    b, c = torch.randn(t, n, generator=g), torch.randn(t, n, generator=g)
    d = torch.randn(h, generator=g)
    got = ref.ssd(x, dt, a, b, c, d)
    assert torch.allclose(got.double(), _recurrence(x, dt, a, b, c, d),
                          rtol=1e-5, atol=1e-5)


def test_reference_is_the_programs_forward_at_f32(tiny):
    """The program's full forward at f32 (SMOKE) on the harness's weights
    gives the reference's logits."""
    from repro_torch.models import transformer
    _, cell = tiny
    m = cell.model
    cfg = lm_system.program_config(m)
    assert cfg.dtype == torch.float32
    w = ref.make_weights(m, torch.Generator().manual_seed(5))
    toks = torch.randint(0, m["vocab"], (40,),
                         generator=torch.Generator().manual_seed(6))
    want, _ = transformer.forward(w, cfg, {"tokens": toks[None]})
    got = ref.logits(w, m, toks, range(40))
    assert torch.allclose(got, want[0].float(), rtol=1e-4, atol=1e-4)


def test_engine_tokens_against_the_reference(tiny):
    """Prefill in chunks, then decode through the paged cache: every
    checked token is the reference's top-1 (f32 on both sides)."""
    res = _run(tiny)
    info = res["_batches"]
    assert res["correct"] and res["failed"] == 0
    assert info["checked"] >= 2 and info["steps_checked"] >= 10
    assert res["checks"]["token_gap"]["value"] <= 1e-4
    assert res["checks"]["lead_miss_share"]["value"] == 0.0


def test_result_line_keys(tiny):
    for traced in (False, True):
        res = _run(tiny, seconds=0.3, traced=traced)
        res.pop("_loaded"), res.pop("_batches")
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        keys += ["breakdown", "checks"] if traced else ["checks"]
        assert list(res) == keys
        assert list(res["checks"]) == list(check.LM_NUMBERS)
        if traced:
            assert set(res["device"]) >= {"busy_s", "window_s"}
            # the CPU runs no device operation: the counter alone is read
            assert set(res["metrics"]) <= {"slot_live_share"}
        else:
            assert set(res["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                           "tpot_p95_ms", "setup_s"}
            assert all(v["value"] > 0 for v in res["metrics"].values())
        json.dumps(res, allow_nan=False)


def test_first_token_step_against_a_recording_engine(tiny):
    """The harness places a request's first token at the end of tick
    ``admitted + chunks - 1``: the engine's own recorder saw it in that
    tick, and its ``ttft_s`` (taken inside the tick) is no longer than the
    harness's, by no more than the tick."""
    from repro_torch.obs.recorder import EngineRecorder
    from repro_torch.serve.engine import Engine
    _, cell = tiny
    m, t = cell.model, cell.traffic
    seen = {}

    class Rec(EngineRecorder):
        def on_first_token(self, req, tick):
            v = super().on_first_token(req, tick)
            seen[req.rid] = (tick, v)
            return v
    eng = Engine(ref.make_weights(m, torch.Generator().manual_seed(1)),
                 lm_system.program_config(m), n_slots=t["n_slots"],
                 max_len=t["max_len"], page_size=t["page_size"],
                 device="cpu", recorder=Rec())
    loop = lm_run.ClosedLoop(eng, lm_traffic.stream(t, m["vocab"], 7),
                             t["sessions"])
    loop.start()
    for _ in range(60):
        loop.step(False)
    assert len(loop.done) >= 10
    assert any(lm_system.chunks(eng, len(d.prompt)) > 1 for d in loop.done)
    for d in loop.done:
        tick, ttft = seen[d.rid]
        first = loop.step_end.index(d.first)
        assert first == tick
        start = loop.step_end[first - 1] if first else d.submitted
        assert 0 <= (d.first - d.submitted) - ttft <= d.first - start


def test_stream_repeats_from_its_seed_and_keeps_its_lengths():
    t = json.loads((REPO / "kanbench" / "traffic"
                    / "engine.offline.c64.json").read_text())
    n = t["block"]

    def take(seed, k=2 * n):
        s = lm_traffic.stream(t, 50280, seed)
        return [next(s) for _ in range(k)]
    a, b, c = take(1), take(1), take(2)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    assert any(len(x[0]) != len(y[0]) for x, y in zip(a, c))
    for reqs in (a, c):                 # each block: the same lengths
        for blk in (reqs[:n], reqs[n:]):
            assert sorted(len(p) for p, _ in blk) == sorted(
                lm_traffic.quantile_lengths(t["prompt"], n))
            assert sorted(m for _, m in blk) == sorted(
                lm_traffic.quantile_lengths(t["output"], n))
    lens = lm_traffic.quantile_lengths(t["prompt"], 1001)
    assert lens[500] == t["prompt"]["median"]
    assert min(lens) == t["prompt"]["min"] and max(lens) == \
        t["prompt"]["max"]
    assert all(p.max() < 50280 and p.min() >= 0 for p, _ in a)


def test_fp8_control_fails(tiny):
    root, cell = tiny
    recs = list(control.readings(cell, [11, 12], 0.6, "codes", device="cpu",
                                 root=root))
    assert all(not r["correct"] and r["weights"] == "float8_e4m3fn"
               for r in recs)
    assert min(r["token_gap"] for r in recs) > 10 * cell.limits["token_gap"]


def test_fp8_rounding_is_per_matrix_and_exact_on_constants():
    g = torch.Generator().manual_seed(0)
    w = {"a": torch.randn(3, 8, 16, generator=g),
         "b": [torch.full((4, 5), math.log(math.e - 1))]}
    r = lm_run.fp8_rounded(w)
    assert torch.equal(r["b"][0], w["b"][0])
    rel = ((r["a"] - w["a"]).abs() / w["a"].abs().amax(dim=(1, 2),
                                                       keepdim=True))
    assert 0 < float(rel.max()) <= 2 ** -4
    assert not torch.equal(r["a"], w["a"])


def test_a_wrong_token_at_a_clear_lead_fails(tiny, monkeypatch):
    """Each completion's third token is replaced where it is produced."""
    step = lm_system.step

    def wrong(eng):
        comps = step(eng)
        for c in comps:
            c.tokens = np.array(c.tokens)
            c.tokens[2] = (c.tokens[2] + 1) % 512
        return comps
    monkeypatch.setattr(lm_system, "step", wrong)
    res = _run(tiny)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["token_gap"]["value"] > 1.0
    assert res["checks"]["lead_miss_share"]["value"] > 0.0


def test_a_dropped_request_fails(tiny, monkeypatch):
    """Once the engine is full, it never sees one request in five: each
    such session stalls."""
    submit = lm_system.submit

    def dropping(eng, rid, prompt, max_new):
        if rid < 40 or rid % 5 != 3:
            submit(eng, rid, prompt, max_new)
    monkeypatch.setattr(lm_system, "submit", dropping)
    res = _run(tiny)
    assert not res["correct"]
    assert res["checks"]["incomplete"]["value"] >= 1


def test_a_short_request_fails(tiny, monkeypatch):
    """A completion that stops one token short of its budget."""
    step = lm_system.step

    def short(eng):
        comps = step(eng)
        for c in comps:
            c.tokens = np.array(c.tokens)[:-1]
        return comps
    monkeypatch.setattr(lm_system, "step", short)
    res = _run(tiny)
    assert not res["correct"] and res["checks"]["incomplete"]["value"] > 0


def test_config_file_is_the_programs():
    from repro_torch.configs import mamba2_1p3b
    m = json.loads((REPO / "kanbench" / "configs"
                    / "mamba2-1.3b.json").read_text())
    cfg = lm_system.program_config(m)
    assert cfg is mamba2_1p3b.CONFIG.model
    assert m["n_heads"] == m["expand"] * m["d_model"] // m["head_dim"]
    assert (m["dtype"], m["param_dtype"]) == ("bfloat16", "float32")
    assert (cfg.dtype, cfg.param_dtype) == (torch.bfloat16, torch.float32)
    ssd = cfg.ssd_cfg
    assert (ssd.expand, ssd.conv_width) == (m["expand"], m["conv_width"])
    with pytest.raises(ValueError):
        lm_system.program_config(dict(m, d_state=64))


def test_ssd_roofline_count():
    from kanbench.roofline import ssd_scan
    flops, n_bytes = ssd_scan.count(256, 64, 64, 128)
    assert flops == 4 * 256 * 64 * 64 * 128
    assert n_bytes == 4 * (2 * 256 * 64 * 64 + 256 * 64 + 2 * 256 * 128
                           + 64 * 64 * 128)


def test_chunks_from_prefill_positions():
    before = [(None, 0), (7, 256), (8, 40), (9, 512)]
    after = [(10, 256), (7, 300), (8, 41), (None, 512)]
    assert lm_system.chunk_lengths(before, after) == [256, 44, 1]

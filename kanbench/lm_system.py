"""The system under test for the LM cells: the program's serving engine
(``repro_torch.serve.engine.Engine``: paged cache, chunked prefill,
continuous batching, one fused decode tick over every slot). This is the
only file that calls the engine: it builds one from the program's
``CONFIG`` that the configuration file names, submits requests and steps
it, and reads its public counters and per-slot state.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Completion, Request

# the configuration file's keys and the program's ModelConfig fields that
# must agree (a widths mismatch is refused before anything runs)
_SAME = {"n_layers": "n_layers", "d_model": "d_model", "vocab": "vocab",
         "d_state": "ssm_state", "head_dim": "ssm_head_dim",
         "chunk": "ssm_chunk"}


def program_config(model: Dict):
    """The program's ``ModelConfig`` named by the file's
    ``program_config`` (``module.ATTR``, an ``ArchConfig`` or a
    ``ModelConfig``), checked against the file's widths."""
    mod, attr = model["program_config"].rsplit(".", 1)
    cfg = getattr(importlib.import_module(mod), attr)
    cfg = getattr(cfg, "model", cfg)
    wrong = {k: (model[k], getattr(cfg, f)) for k, f in _SAME.items()
             if model[k] != getattr(cfg, f)}
    if wrong:
        raise ValueError(f"{model['name']}: the file and the program's "
                         f"config differ (file, program): {wrong}")
    return cfg


def engine(params: Dict, model: Dict, traffic: Dict, device) -> Engine:
    """The engine of the traffic's geometry over ``params`` (the program's
    parameter tree, used as given)."""
    return Engine(params, program_config(model), n_slots=traffic["n_slots"],
                  max_len=traffic["max_len"], page_size=traffic["page_size"],
                  device=device)


def submit(eng: Engine, rid: int, prompt: np.ndarray, max_new: int) -> None:
    if not eng.submit(Request(rid=rid, tokens=prompt, max_new=max_new)):
        raise RuntimeError(f"the engine refused request {rid}")


def step(eng: Engine) -> List[Completion]:
    """One engine tick; the requests it completed."""
    return eng.step()


def tick(eng: Engine) -> int:
    """The number of the next tick (``Completion.admitted_tick`` counts
    the same ticks)."""
    return eng.tick_no


def chunks(eng: Engine, prompt_len: int) -> int:
    """Prefill ticks of a prompt: one a chunk (the whole prompt in one tick
    where the engine does not chunk). No prefix page is ever matched here:
    the traffic's prompts share none."""
    c = eng.chunk_tokens
    return 1 if c is None else -(-prompt_len // c)


def counters(eng: Engine) -> Dict[str, int]:
    """The engine's cumulative counters (``EngineStats``)."""
    s = eng.stats
    return {"decode_tokens": s.decode_tokens, "prefills": s.prefills,
            "occupancy_ticks": s.occupancy_ticks,
            "decode_ticks": s.decode_ticks, "n_slots": eng.n_slots,
            "completed": s.completed}


def prefill_positions(eng: Engine) -> List[Tuple[object, int]]:
    """Each slot's request id (None if free) and prompt tokens consumed."""
    return [(None if r is None else r.rid, int(p))
            for r, p in zip(eng.slot_req, eng.slot_pos)]


def chunk_lengths(before, after) -> List[int]:
    """The prefill chunks that ran between two ``prefill_positions``: a
    slot holding a new request consumed its position, one holding the same
    request the difference (0 when it decodes)."""
    out = []
    for (r0, p0), (r1, p1) in zip(before, after):
        if r1 is None:
            continue
        n = p1 if r1 != r0 else p1 - p0
        if n > 0:
            out.append(n)
    return out

"""Collective traffic and per-rank FLOPs (port of ``repro.analysis``).

Collective cost model (ring algorithms, per-rank bytes moved), applied to
each collective from its OUTPUT bytes ``o`` and its group size ``n``, as
the reference derives it from optimized HLO:

  all-gather         o x (n-1)/n
  all-reduce         2 x o x (n-1)/n    (RS + AG)
  reduce-scatter     o x (n-1)
  all-to-all         o x (n-1)/n
  collective-permute o

Where the reference parses the collectives out of XLA's HLO text, the port
counts them as they run: ``CollectiveBytes`` is a dispatch mode over the
functional collectives (``_c10d_functional``, what DTensor and the MoE's
expert-parallel path issue), and records one ``Collective`` (kind, output
bytes, group size) per call. Counting at that level, not at the process
group's, sees an all-to-all as one even when a backend (the CPU's fake
group) emulates it with an all-gather. ``collective_traffic`` turns the
records into per-rank bytes moved.

``FlopCounter`` counts each operation's FLOPs on the rank's own shards:
``torch.utils.flop_counter``'s formulas on the op's global shapes, divided
by the ways the op's output is split or partial over the mesh (each rank
computes that share), and the local shapes' FLOPs for plain tensors (the
bodies of ``local_map``). It also sums the bytes each non-view op reads
and writes on the rank (``bytes_accessed``: per eager op, no fusion).
``LiveBytes`` follows the bytes of the rank's op outputs that are still
alive, and their peak.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional collective -> the reference's HLO kind
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": None}


class Collective(NamedTuple):
    """One collective call on this rank: its kind (``KINDS``), the bytes
    of its output on this rank and the size of its group."""
    kind: str
    out_bytes: int
    group: int


def collective_traffic(records: Iterable[Collective]) -> Dict[str, float]:
    """Per-rank bytes moved, by collective kind, and their ``total``."""
    out: Dict[str, float] = {k: 0.0 for k in KINDS}
    for rec in records:
        o, n = float(rec.out_bytes), max(int(rec.group), 1)
        if rec.kind == "all-gather":
            moved = o * (n - 1) / n
        elif rec.kind == "all-reduce":
            moved = 2.0 * o * (n - 1) / n
        elif rec.kind == "reduce-scatter":
            moved = o * (n - 1)
        elif rec.kind == "all-to-all":
            moved = o * (n - 1) / n
        elif rec.kind == "collective-permute":
            moved = o
        else:
            raise ValueError(f"unknown collective kind {rec.kind!r}")
        out[rec.kind] += moved
    out["total"] = sum(out.values())
    return out


def _group_size(args) -> int:
    """The size of a functional collective's group, which it names in its
    last string argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args[1:] if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveBytes(TorchDispatchMode):
    """While active, every functional collective by op: ``calls`` and
    input ``bytes`` (as a rank issues them), and ``records``, one
    ``Collective`` per call of a kind the cost model knows."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.records: List[Collective] = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, _, op = str(func.overloadpacket).rpartition(".")
        if ns.endswith("_c10d_functional") and op in _FUNCTIONAL:
            n = sum(_nbytes(a) for a in args if isinstance(a, torch.Tensor))
            self.calls[op] = self.calls.get(op, 0) + 1
            self.bytes[op] = self.bytes.get(op, 0) + n
            kind = _FUNCTIONAL[op]
            if kind is not None:
                self.records.append(Collective(kind, _nbytes(out),
                                               _group_size(args)))
        return out

    def input_bytes_by_kind(self) -> Dict[str, int]:
        """Input bytes by the reference's kind (its ``collective_bytes``
        sums operand bytes)."""
        out: Dict[str, int] = {}
        for op, n in self.bytes.items():
            kind = _FUNCTIONAL[op]
            if kind is not None:
                out[kind] = out.get(kind, 0) + n
        return out

    def traffic(self) -> Dict[str, float]:
        return collective_traffic(self.records)


def _split_ways(t) -> int:
    """The ranks that share the work of producing the DTensor ``t``: the
    product of the mesh dims on which it is split or partial."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return 1
    ways = 1
    for i, p in enumerate(t.placements):
        if not p.is_replicate():
            ways *= t.device_mesh.size(i)
    return ways


def _local_nbytes(t) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return _nbytes(t)


class FlopCounter(TorchDispatchMode):
    """While active, this rank's ``flops`` and ``bytes_accessed`` (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes_accessed = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        outs = [o for o in outs if isinstance(o, torch.Tensor)]
        formula = self._formulas.get(func.overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n // _split_ways(outs[0]) if outs else n
        if not func.is_view:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            self.bytes_accessed += sum(_local_nbytes(t) for t in ins + outs)
        return out


class LiveBytes(TorchDispatchMode):
    """While active, the bytes of this rank's op outputs that are still
    alive (``live``; a DTensor counts its local shard) and their ``peak``.
    An output that is a view, or that an in-place op hands back, shares
    bytes already counted and is not counted again."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable:
            return out
        from torch.distributed.tensor import DTensor
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            loc = t._local_tensor if isinstance(t, DTensor) else t
            n = _nbytes(loc)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(loc, self._free, n)
        return out

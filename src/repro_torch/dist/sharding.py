"""Logical-axis rules as DTensor placements (port of
``repro.dist.sharding``).

Model code never names mesh dims. It tags tensor dims with *logical* names
("batch", "embed", "kv_heads", ...) and this module resolves them against
whatever mesh is current: the 16x16 production mesh, the 2x16x16 multi-pod
mesh, a 2x2 host mesh of processes, or no mesh at all (``shard`` is then
the identity).

``spec_for`` is the reference's resolution, unchanged: it walks the tensor
dims left to right; for each logical name ``RULES`` lists candidate mesh
axes in priority order (a candidate may merge several axes, e.g. batch over
``("pod", "data")``). A candidate is taken only if every axis exists in the
mesh, none is already used by an earlier dim of the same tensor, and the
combined axis size divides the dim; otherwise the next candidate is tried,
else the dim replicates. It returns the reference's ``PartitionSpec``
entries as a tuple: ``None``, one axis name, or a tuple of names.

``placements_for`` turns those entries into one ``Shard(d)`` or
``Replicate()`` per mesh dim of a torch ``DeviceMesh`` (named dims). An
entry naming two axes shards one tensor dim over two mesh dims; DTensor
nests them in mesh-dim order, the first mesh dim major, which is JAX's
order for ``("pod", "data")`` on a ``(pod, data, model)`` mesh.

``use_mesh(mesh)`` is the counterpart of ``with mesh:``; ``shard(x,
*names)`` redistributes a DTensor to the resolved placements and is the
identity on a plain tensor or without a current mesh. Unlike JAX's mesh
context, the current mesh and the rule overrides are the process's, not a
thread's: autograd runs a CUDA backward on its own device thread, and a
block that ``torch.utils.checkpoint`` recomputes there must resolve its
``shard`` calls as the forward did.
``tree_shardings``/``distribute_tree`` place a parameter tree by its
``param_spec``.
"""
from __future__ import annotations

import contextlib
import types
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

# logical name -> candidates, tried in order; each candidate is one mesh
# axis or a tuple of mesh axes sharded jointly.  () = always replicate.
RULES: Dict[str, Tuple[Any, ...]] = {
    "batch":    (("pod", "data"), "data"),   # data parallel; pods merge
    "seq":      (),                          # sequence stays local
    "seq_sp":   ("model",),                  # Megatron-style seq parallel
    "embed":    ("data",),                   # FSDP: params shard over data
    "vocab":    ("model",),                  # tensor-parallel (un)embedding
    "heads":    ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),                  # KV fallback when kv_heads ∤
    "mlp":      ("model",),
    "state":    ("model",),                  # ssd / rg-lru widths
    "experts":  ("model",),                  # expert-parallel shard dim
    "layers":   (),                          # stacked-layer axis
    "none":     (),
}

Entry = Optional[Any]   # None, "axis" or ("axis", "axis")

# the current mesh and rule overrides (process-wide: see the docstring)
_local = types.SimpleNamespace(mesh=None, overrides=None)


def _active_rules() -> Dict[str, Tuple[Any, ...]]:
    over = _local.overrides
    if not over:
        return RULES
    merged = dict(RULES)
    merged.update(over)
    return merged


def _as_candidates(value) -> Tuple[Any, ...]:
    """Accept "model", ("model",), (("pod","data"), "data"), or ()."""
    if value is None:
        return ()
    if isinstance(value, str):
        return (value,)
    return tuple(value)


@contextlib.contextmanager
def override_rules(**overrides):
    """Replace rule entries, e.g. ``override_rules(embed=())`` to
    replicate embeddings.  Nests; restores the previous state on exit."""
    prev = _local.overrides
    merged = dict(prev or {})
    merged.update({k: _as_candidates(v) for k, v in overrides.items()})
    _local.overrides = merged
    try:
        yield
    finally:
        _local.overrides = prev


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims, or None for no
    mesh) current, the counterpart of the reference's ``with mesh:``.
    Nests."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _local.mesh
    _local.mesh = mesh
    if mesh is None:        # no mesh: shard() is the identity inside
        try:
            yield None
        finally:
            _local.mesh = prev
        return
    try:
        # a plain tensor met by a DTensor (positions, masks, constants made
        # inside the model) counts as replicated on the mesh
        with implicit_replication():
            yield mesh
    finally:
        _local.mesh = prev


def current_mesh():
    """The mesh entered with ``use_mesh``, or None outside any."""
    return _local.mesh


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (its dim names and shape) or
    of anything whose ``.shape`` is such a mapping (the tests' fake
    meshes)."""
    if mesh is None:
        return {}
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(shape: Sequence[int], names: Sequence[Optional[str]],
             mesh=None) -> Tuple[Entry, ...]:
    """Resolve logical ``names`` for a tensor of ``shape`` into the
    reference's PartitionSpec entries on ``mesh`` (default the current
    one). No mesh axis is assigned twice within one tensor."""
    mesh = mesh if mesh is not None else current_mesh()
    sizes = mesh_sizes(mesh)
    rules = _active_rules()
    if len(names) > len(shape):
        raise ValueError(f"{len(names)} logical names {tuple(names)} for a "
                         f"rank-{len(shape)} tensor of shape {tuple(shape)}")
    names = tuple(names) + (None,) * (len(shape) - len(names))
    used: set = set()
    entries = []
    for dim, name in zip(shape, names):
        entry = None
        for cand in rules.get(name or "none", ()):
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if not all(a in sizes for a in axes):
                continue
            if any(a in used for a in axes):
                continue
            n = 1
            for a in axes:
                n *= sizes[a]
            if n <= 1 or dim % n != 0:
                continue
            entry = axes[0] if len(axes) == 1 else axes
            used.update(axes)
            break
        entries.append(entry)
    return tuple(entries)


def placements_for(spec: Sequence[Entry], mesh) -> Tuple[Any, ...]:
    """One ``Shard(d)`` or ``Replicate()`` per dim of ``mesh`` for the
    PartitionSpec entries ``spec``. An entry of several axes must name
    them in the mesh's dim order (DTensor nests them that way)."""
    from torch.distributed.tensor import Replicate, Shard
    dims = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in dims]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [dims.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry} is not in the mesh's dim order "
                             f"{tuple(dims)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and one placement per mesh dim (the reference's
    ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]


def named_sharding(mesh, shape: Sequence[int],
                   names: Sequence[Optional[str]]) -> NamedSharding:
    """The placements on ``mesh`` for a tensor of ``shape`` tagged
    ``names``."""
    return NamedSharding(mesh, placements_for(spec_for(shape, names, mesh),
                                              mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements_of(x) -> Tuple[Any, ...]:
    """``x.placements`` with every ``Shard`` dim non-negative (DTensor's
    sharding propagation can hand back ``Shard(-1)``)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim % x.ndim) if p.is_shard() and p.dim < 0 else p
                 for p in x.placements)


def as_dtensors(*tensors):
    """The mesh of the first DTensor among ``tensors`` and the tensors as
    DTensors on it (a plain tensor taken as replicated, None kept), or
    (None, tensors) when none is a DTensor."""
    mesh = next((t.device_mesh for t in tensors if is_dtensor(t)), None)
    if mesh is None:
        return None, tensors
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    return mesh, tuple(
        t if t is None or is_dtensor(t) else
        DTensor.from_local(t, mesh, rep, run_check=False) for t in tensors)


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; the gradient comes back contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself in the forward, with its gradient made contiguous: a
    ``local_map`` input's local gradient can come back with permuted
    strides, which a DTensor view upstream cannot take."""
    return _ContiguousGrad.apply(x) if x.requires_grad else x


class _PinGrad(torch.autograd.Function):
    """Identity forward; the gradient is redistributed to the forward's
    placements (a partial one's gradient replicates)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.want = tuple(Replicate() if p.is_partial() else p
                         for p in placements_of(x))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and placements_of(g) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g


def pin_grad(x):
    """``x`` itself, its gradient placed as ``x`` is: a gradient that comes
    back split on a dim the forward kept whole (the sequence, from a
    ``seq_sp`` residual) would reach a product's backward, which flattens
    that dim, and DTensor (torch 2.11) refuses that."""
    return _PinGrad.apply(x) if is_dtensor(x) and x.requires_grad else x


def shard(x, *names):
    """Redistribute the DTensor ``x`` to the placements its logical
    ``names`` resolve to on the current mesh; the identity on a plain
    tensor or when no mesh is current, so model code calls it
    unconditionally."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = named_sharding(mesh, x.shape, names).placements
    if placements_of(x) == want:
        return x
    return x.redistribute(mesh, want)


def _flatten_up_to(tree, spec_tree):
    """(leaf, names) pairs of ``tree``, in its own order, with the names
    ``spec_tree`` gives it (nested dicts and lists; a tuple of names is a
    leaf of ``spec_tree``)."""
    if isinstance(spec_tree, tuple):
        return [(tree, spec_tree)]
    if isinstance(spec_tree, Mapping):
        if set(tree) != set(spec_tree):
            raise ValueError(f"tree keys {sorted(tree)} != spec keys "
                             f"{sorted(spec_tree)}")
        return [p for k in tree for p in _flatten_up_to(tree[k],
                                                        spec_tree[k])]
    if len(tree) != len(spec_tree):
        raise ValueError(f"{len(tree)} entries against {len(spec_tree)} "
                         f"specs")
    return [p for t, s in zip(tree, spec_tree) for p in _flatten_up_to(t, s)]


def _rebuild(tree, spec_tree, it):
    """``tree``'s structure, in its own order, with the next item of
    ``it`` at each leaf that ``spec_tree`` names."""
    if isinstance(spec_tree, tuple):
        return next(it)
    if isinstance(spec_tree, Mapping):
        return {k: _rebuild(tree[k], spec_tree[k], it) for k in tree}
    return [_rebuild(t, s, it) for t, s in zip(tree, spec_tree)]


def tree_shardings(mesh, tree, spec_tree):
    """A ``NamedSharding`` for every leaf of ``tree`` (tensors or anything
    with a ``.shape``), ``spec_tree`` mirroring it with tuples of logical
    names at the leaves (the ``param_spec``/``cache_spec`` convention)."""
    pairs = _flatten_up_to(tree, spec_tree)
    return _rebuild(tree, spec_tree, iter(
        [named_sharding(mesh, leaf.shape, names) for leaf, names in pairs]))


def distribute_tree(tree, mesh, spec_tree):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    logical names. Each rank holds the whole leaf (drawn from the same
    seed) and keeps its own shard: no collective is issued."""
    from torch.distributed.tensor import DTensor
    pairs = _flatten_up_to(tree, spec_tree)
    return _rebuild(tree, spec_tree, iter([
        leaf if isinstance(leaf, DTensor) else local_to_dtensor(
            leaf, mesh, named_sharding(mesh, leaf.shape, names).placements)
        for leaf, names in pairs]))


def replicate_tree(tree, mesh):
    """Every plain tensor leaf of nested dicts and lists as a DTensor
    replicated on ``mesh``; DTensors and any other node (a deployed KAN
    artifact, which a rank holds whole and plain) stay as they are."""
    if isinstance(tree, Mapping):
        return {k: replicate_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicate_tree(v, mesh) for v in tree]
    if not isinstance(tree, torch.Tensor) or is_dtensor(tree):
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(tree, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shardings_of(tree):
    """The ``NamedSharding`` of every DTensor leaf of ``tree`` (nested
    dicts, lists and tuples; None for any other leaf): the target of an
    elastic ``checkpoint.restore``."""
    if isinstance(tree, Mapping):
        return {k: shardings_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [shardings_of(v) for v in tree]
    if is_dtensor(tree):
        return NamedSharding(tree.device_mesh, placements_of(tree))
    return None


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (even splits:
    the rules only shard a dim that its axes divide)."""
    out = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        n = mesh.size(i)
        step = out.shape[p.dim] // n
        out = out.narrow(p.dim, coord[i] * step, step)
    return out


def local_to_dtensor(full: torch.Tensor, mesh, placements):
    """``full`` (the same on every rank) as a DTensor with ``placements``,
    from this rank's slice alone."""
    from torch.distributed.tensor import DTensor
    full = full.contiguous()
    loc = local_shard(full, mesh, placements).contiguous()
    return DTensor.from_local(loc, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def full(x):
    """``x`` whole on every rank: a DTensor gathered to a plain tensor,
    anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _local_ranges(x) -> Dict[int, Tuple[int, int]]:
    """dim -> (first index, length) of this rank's shard of the DTensor
    ``x`` along every sharded dim (nested splits as ``local_shard``)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    out: Dict[int, Tuple[int, int]] = {}
    for i, p in enumerate(placements_of(x)):
        if p.is_shard():
            lo, n = out.get(p.dim, (0, x.shape[p.dim]))
            n //= mesh.size(i)
            out[p.dim] = (lo + coord[i] * n, n)
    return out


def setitem_(dst, index, src) -> None:
    """``dst[index] = src`` in place, also for a DTensor ``dst``, whose
    local shard each rank writes itself (DTensor's own in-place indexing
    cannot move ``dst``). ``index`` is a tuple of per-dim selectors over
    ``dst``'s leading dims: ints, step-1 slices, and long tensors
    (consecutive, on dims no mesh dim splits: the page tables). ``src``
    has the indexed result's full shape; it is brought to the placements
    of ``dst``'s shard (replicated along a split dim that an int or a
    partial slice selects, so the rank that holds the row writes it)."""
    index = index if isinstance(index, tuple) else (index,)
    if not is_dtensor(dst):          # one write, as without a mesh
        if index:
            dst[index] = src.to(dst.dtype)
        else:
            dst.copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    sel = list(index) + [slice(None)] * (dst.ndim - len(index))
    src_dim: Dict[int, int] = {}
    s, adv = 0, False
    for d, ix in enumerate(sel):
        if isinstance(ix, torch.Tensor):
            if not adv:
                s += ix.ndim
                adv = True
        elif not isinstance(ix, int):
            src_dim[d] = s
            s += 1
    narrow = []                      # (src dim, start, length)
    whole = set()                    # split dims written whole
    for d, (lo, n) in _local_ranges(dst).items():
        ix = sel[d]
        if isinstance(ix, torch.Tensor):
            raise ValueError(f"setitem_: a tensor index on dim {d}, which "
                             "the mesh splits")
        if isinstance(ix, int):
            ix = ix % dst.shape[d]
            if not lo <= ix < lo + n:
                return               # another rank holds the row
            sel[d] = ix - lo
            continue
        start, stop, step = ix.indices(dst.shape[d])
        if step != 1:
            raise ValueError("setitem_: slices must have step 1")
        if (start, stop) == (0, dst.shape[d]):
            whole.add(d)             # src is split alike
            continue
        a, b = max(start, lo), min(stop, lo + n)
        if a >= b:
            return
        sel[d] = slice(a - lo, b - lo)
        narrow.append((src_dim[d], a - start, b - a))
    mesh = dst.device_mesh
    want = []
    for p in placements_of(dst):
        want.append(Shard(src_dim[p.dim]) if p.is_shard() and p.dim in whole
                    else Replicate())
    if is_dtensor(src):
        loc = src.redistribute(mesh, want).to_local()
    else:
        loc = local_shard(src, mesh, want)
    for d, a, n in narrow:
        loc = loc.narrow(d, a, n)
    dst.to_local()[tuple(sel)] = loc.to(dst.dtype)

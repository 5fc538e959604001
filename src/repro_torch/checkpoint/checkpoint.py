"""Checkpointing (port of ``repro.checkpoint.checkpoint``): atomic, async,
the reference's on-disk layout.

Layout: ``<dir>/step_<N:08d>/`` with one ``.npy`` per leaf of the tree,
numbered in the sorted order of the leaf keys, and a ``manifest.json``
with the reference's keys (``step``, ``leaves``: key -> file, ``treedef``,
``extra``). A leaf's key is its path in the tree joined by ``/``: a dict
key, a list or tuple index, or ``.codes``/``.scale`` inside an optimizer
``QTensor`` (the strings JAX's key paths give). A tree saved by either
package therefore restores into the other. A bf16 leaf is stored as JAX
stores it, as the raw 2-byte words (numpy dtype ``V2``).

Writes go to a temp directory, then one rename: a preempted writer never
leaves a half-written step that readers could take (``latest_step`` takes
the newest step with a manifest). ``save_async`` snapshots to host memory
first and writes on a thread. ``restore`` places every leaf on its
template leaf's device in its dtype.

Under a mesh (DTensor leaves) every rank calls ``save``: each DTensor leaf
is gathered once (``full_tensor``), rank 0 writes, and a synchronous save
ends at a barrier. ``restore(..., shardings=)`` is the elastic resharding:
each rank reads the whole leaf and keeps its own shard for the target
placements (``dist.sharding.NamedSharding``, e.g. from ``tree_shardings``
or ``shardings_of``), with no collective; a DTensor template leaf with no
sharding given keeps its own placements. The files are the same whatever
the mesh, so a checkpoint written on one mesh restores on another, or on
one device, in either package.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (NamedSharding, is_dtensor,
                                       local_to_dtensor)
from repro_torch.optim.optimizers import QTensor

PyTree = Any


def _items(tree):
    """(key part, child) of a tree node, or None for a leaf (a
    ``NamedSharding`` is a leaf of a shardings tree)."""
    if isinstance(tree, NamedSharding):
        return None
    if isinstance(tree, QTensor):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaf key -> leaf (a ``None`` is an empty subtree, as in JAX)."""
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaf_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _treedef(tree) -> str:
    """The tree's structure in JAX's ``PyTreeDef`` notation (informative:
    neither package reads it back)."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, QTensor):
            return ("QTensor(" + ", ".join(f"{f}={node(getattr(t, f))}"
                                           for f in t._fields) + ")")
        if isinstance(t, Mapping):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array that no later write to the leaf can
    change (bf16 as its raw words, dtype ``V2``); a DTensor is gathered
    whole first (a collective: every rank calls this)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 or \
            arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the one
    process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save (in a process group: every rank calls it,
    rank 0 writes, all return after a barrier)."""
    host = {k: _host(v) for k, v in _leaf_paths(tree).items()}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        final = _write(ckpt_dir, step, host, _treedef(tree), extra)
    if dist.is_initialized():
        dist.barrier()
    return final


def save_async(ckpt_dir: str, step: int, tree: PyTree,
               extra: Optional[Dict] = None) -> threading.Thread:
    """Snapshot to host now, write in the background; returns the writer
    thread (in a process group every rank calls it and rank 0's thread
    writes; the others' threads do nothing)."""
    host = {k: _host(v) for k, v in _leaf_paths(tree).items()}
    args = (ckpt_dir, step, host, _treedef(tree), extra)
    t = threading.Thread(target=_write if _writer() else lambda *a: None,
                         args=args, daemon=True)
    t.start()
    return t


def _write(ckpt_dir, step, host_leaves, treedef, extra):
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    # a temp dir per writer: an async periodic save racing a final
    # synchronous save of the same step must not share one
    tmp = final + f".tmp{os.getpid()}_{threading.get_ident()}"
    os.makedirs(tmp, exist_ok=True)
    names = {}
    for i, (key, arr) in enumerate(sorted(host_leaves.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        names[key] = fname
    manifest = {"step": step, "leaves": names, "treedef": treedef,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    try:
        os.rename(tmp, final)
    except OSError:
        # another writer completed the same step first; ours is redundant
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _rebuild(template, leaves: Dict[str, Any], prefix: str = ""):
    if template is None:
        return None
    items = _items(template)
    if items is None:
        return leaves[prefix]
    kids = {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in items}
    if isinstance(template, QTensor):
        return QTensor(*(kids["." + f] for f in template._fields))
    if isinstance(template, Mapping):
        return {k: kids[str(k)] for k in template}
    return type(template)(kids[str(i)] for i in range(len(template)))


def restore(ckpt_dir: str, template: PyTree, step: Optional[int] = None,
            shardings: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``template`` (the latest step unless
    ``step`` is given): each leaf cast to its template leaf's dtype and
    placed on its device. ``shardings`` mirrors ``template`` with a
    ``NamedSharding`` (or None) per leaf: such a leaf becomes a DTensor
    with those placements, built from this rank's slice of the file (as
    does a DTensor template leaf without one). Returns (tree, the
    manifest's ``extra``)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = manifest["leaves"]
    placed = {} if shardings is None else {
        k: v for k, v in _leaf_paths(shardings).items() if v is not None}
    out = {}
    for key, tmpl in _leaf_paths(template).items():
        t = _tensor(np.load(os.path.join(d, names[key])))
        target = placed.get(key)
        if target is None and is_dtensor(tmpl):
            target = NamedSharding(tmpl.device_mesh, tuple(tmpl.placements))
        if isinstance(tmpl, torch.Tensor):
            dev = (tmpl.to_local() if is_dtensor(tmpl) else tmpl).device
            t = t.to(device=dev, dtype=tmpl.dtype)
        if target is not None:
            t = local_to_dtensor(t, target.mesh, target.placements)
        out[key] = t
    return _rebuild(template, out), manifest["extra"]


def verify(ckpt_dir: str, tree: PyTree, step: Optional[int] = None) -> int:
    """Check that every leaf of ``tree`` (a restore's result; DTensor
    leaves are gathered whole, a collective: every rank calls this)
    equals its file of ``step`` (default the latest) bit for bit; raises
    otherwise. Returns the number of leaves checked."""
    step = step if step is not None else latest_step(ckpt_dir)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        names = json.load(f)["leaves"]
    leaves = _leaf_paths(tree)
    for key, leaf in leaves.items():
        got = _host(leaf)
        want = np.load(os.path.join(d, names[key]))
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            raise AssertionError(f"leaf {key} differs from step {step}'s "
                                 f"file")
    return len(leaves)


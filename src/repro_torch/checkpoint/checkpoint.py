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
template leaf's device in its dtype; elastic resharding onto a mesh
(``shardings``) is Slice F.
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

from repro_torch.optim.optimizers import QTensor

PyTree = Any
MESH_SLICE = "ROADMAP Slice F (distribution)"


def _items(tree):
    """(key part, child) of a tree node, or None for a leaf."""
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
    change (bf16 as its raw words, dtype ``V2``)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
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


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save."""
    host = {k: _host(v) for k, v in _leaf_paths(tree).items()}
    return _write(ckpt_dir, step, host, _treedef(tree), extra)


def save_async(ckpt_dir: str, step: int, tree: PyTree,
               extra: Optional[Dict] = None) -> threading.Thread:
    """Snapshot to host now, write in the background; returns the writer
    thread."""
    host = {k: _host(v) for k, v in _leaf_paths(tree).items()}
    t = threading.Thread(target=_write, args=(ckpt_dir, step, host,
                                              _treedef(tree), extra),
                         daemon=True)
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
    placed on its device. Returns (tree, the manifest's ``extra``)."""
    if shardings is not None:
        raise NotImplementedError(
            f"restore onto a mesh (shardings) is not ported yet: "
            f"{MESH_SLICE}")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = manifest["leaves"]
    out = {}
    for key, tmpl in _leaf_paths(template).items():
        t = _tensor(np.load(os.path.join(d, names[key])))
        if isinstance(tmpl, torch.Tensor):
            t = t.to(device=tmpl.device, dtype=tmpl.dtype)
        out[key] = t
    return _rebuild(template, out), manifest["extra"]

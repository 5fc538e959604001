"""Optimizers (port of ``repro.optim.optimizers``): an optax-like
``init``/``update`` pair over parameter trees of tensors (nested dicts and
lists, the JAX layout), with states in the reference's layout, so a state
carries across leaf by leaf.

* ``adamw`` — ``{"m", "v", "step"}``, m and v f32 trees shaped as the
  params; with ``quantize_moments`` (``adamw8``) each moment leaf is a
  ``QTensor``: int8 codes with one f32 scale per leading row, m quantised
  directly, v stored as the int8 of sqrt(v).
* ``adafactor`` — ``{"mom", "step"}``, a factored second moment: a leaf of
  two or more dims keeps row and column accumulators over its two largest
  dims (``{"vr", "vc"}``), a smaller one the full ``{"v"}``.

Updates are plain f32 tensor arithmetic, leaf by leaf, in the reference's
order of operations; ``step`` is an int32 scalar tensor. With DTensor
parameters (a mesh, ``dist.sharding``) every moment is a DTensor placed as
its parameter (Adafactor's row and column moments as the parameter less the
reduced dim), and the reductions (the global norm, Adafactor's factored
means and its update RMS) are DTensor reductions over the whole tensor;
call ``update`` inside ``dist.sharding.use_mesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Tuple

import torch

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]
    name: str = "opt"


class QTensor(NamedTuple):
    codes: Tensor     # int8 (f32 for a scalar leaf)
    scale: Tensor     # per-row (leading-dim) f32 scale


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching)`` over the leaves of ``tree`` (tensors or
    ``QTensor``s inside nested dicts, lists and tuples); each of ``rest``
    is walked along ``tree``'s structure, and whatever it holds at a leaf's
    place (a tensor, a ``QTensor`` or a dict of them) is passed whole."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


class _Out:
    """A leaf's results, kept whole by ``tree_map`` (a tuple would be
    walked into)."""

    def __init__(self, *items):
        self.items = items


def _zeros_f32(p: Tensor, drop: int = -1) -> Tensor:
    """f32 zeros shaped as ``p`` (less dim ``drop`` if given), placed as
    ``p`` when it is a DTensor: a dropped dim's shards replicate and the
    shards of later dims move down one."""
    from repro_torch.dist.sharding import is_dtensor, placements_of
    shape = tuple(s for i, s in enumerate(p.shape) if i != drop)
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros
    pl = []
    for q in placements_of(p):
        if not q.is_shard() or (drop >= 0 and q.dim == drop):
            pl.append(Replicate())
        else:
            pl.append(Shard(q.dim - 1 if 0 <= drop < q.dim else q.dim))
    if p.to_local().is_meta:    # the dry run: shapes only, on meta
        from repro_torch.dist.sharding import local_to_dtensor
        return local_to_dtensor(torch.zeros(shape, dtype=torch.float32,
                                            device="meta"), p.device_mesh, pl)
    return dzeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                  placements=pl)


def _unzip(out, n: int) -> list:
    return [tree_map(lambda o, i=i: o.items[i], out) for i in range(n)]


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# --- schedules / clipping ----------------------------------------------------

def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[Tensor], Tensor]:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor * peak_lr`` at ``total``; f32 as the reference's."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return sched


def global_norm(tree: PyTree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm: float
                        ) -> Tuple[PyTree, Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm


# --- int8 moment compression -------------------------------------------------

def _q8(x: Tensor) -> QTensor:
    """Per-leading-row int8 codes: scale = max(|row|, 1e-12) / 127, codes
    rounded half to even (``jnp.round``) and clipped to +-127."""
    if x.ndim == 0:
        return QTensor(codes=x.to(torch.float32),
                       scale=torch.ones((), device=x.device))
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    amax = torch.amax(torch.abs(flat), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return QTensor(codes=codes.reshape(x.shape), scale=scale[:, 0])


def _dq8(q: QTensor, shape) -> Tensor:
    if q.codes.ndim == 0 or q.codes.dtype != torch.int8:
        return q.codes.to(torch.float32)
    flat = (q.codes.reshape(shape[0], -1).to(torch.float32)
            * q.scale[:, None])
    return flat.reshape(shape)


# --- AdamW -------------------------------------------------------------------

def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          quantize_moments: bool = False) -> Optimizer:
    if quantize_moments:
        eps = max(eps, 1e-6)   # guard against zero-quantised denominators

    def init(params):
        def zeros(p):
            z = _zeros_f32(p)
            return _q8(z) if quantize_moments else z
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}

    def update(grads, state, params, _step_unused=None):
        step = state["step"] + 1
        lr_t = lr(step)
        b1c = 1 - b1 ** step.to(torch.float32)
        b2c = 1 - b2 ** step.to(torch.float32)

        def upd(p, g, m_old, v_old):
            gf = g.to(torch.float32)
            if quantize_moments:
                # m quantised directly; v stored as the int8 of sqrt(v)
                m_prev = _dq8(m_old, p.shape)
                v_prev = _dq8(v_old, p.shape) ** 2
            else:
                m_prev, v_prev = m_old, v_old
            m = b1 * m_prev + (1 - b1) * gf
            v = b2 * v_prev + (1 - b2) * gf * gf
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            u = u + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr_t * u).to(p.dtype)
            if quantize_moments:
                return _Out(new_p, _q8(m), _q8(torch.sqrt(v)))
            return _Out(new_p, m, v)

        new_p, m, v = _unzip(tree_map(upd, params, grads, state["m"],
                                      state["v"]), 3)
        return new_p, {"m": m, "v": v, "step": step}

    return Optimizer(init=init, update=update,
                     name="adamw8" if quantize_moments else "adamw")


# --- Adafactor ---------------------------------------------------------------

def _factored_dims(shape):
    if len(shape) < 2:
        return None
    dims = sorted(range(len(shape)), key=lambda i: shape[i])[-2:]
    return tuple(sorted(dims))


def adafactor(lr: Callable, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern). Tensors with >= 2 dims
    keep row/col accumulators over their two largest dims; 0/1-dim ones
    keep the full v."""

    def init(params):
        def make(p):
            f = _factored_dims(p.shape)
            if f is None:
                return {"v": _zeros_f32(p)}
            d0, d1 = f
            return {"vr": _zeros_f32(p, drop=d1), "vc": _zeros_f32(p, drop=d0)}
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"mom": tree_map(make, params), "step": step}

    def update(grads, state, params, _unused=None):
        step = state["step"] + 1
        lr_t = lr(step)
        beta = 1.0 - step.to(torch.float32) ** (-decay)

        def upd(p, g, s):
            f = _factored_dims(p.shape)
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            if f is None:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(v + eps)
                new_s = {"v": v}
            else:
                d0, d1 = f
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=d1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=d0)
                # V_hat = (vr (x) vc) / mean(vr): d0 < d1, so d0 keeps its
                # index inside vr (d1 was removed)
                vr_e = vr.unsqueeze(d1)
                vc_e = vc.unsqueeze(d0)
                mean_r = vr.mean(dim=d0, keepdim=True).unsqueeze(d1)
                denom = vr_e * vc_e / torch.clamp(mean_r, min=eps)
                u = gf * torch.rsqrt(torch.clamp(denom, min=eps))
                new_s = {"vr": vr, "vc": vc}
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return _Out((p.to(torch.float32) - lr_t * u).to(p.dtype), new_s)

        new_p, mom = _unzip(tree_map(upd, params, grads, state["mom"]), 2)
        return new_p, {"mom": mom, "step": step}

    return Optimizer(init=init, update=update, name="adafactor")


def make_optimizer(kind: str, lr_schedule: Callable, **kw) -> Optimizer:
    if kind == "adamw":
        return adamw(lr_schedule, **kw)
    if kind == "adamw8":
        return adamw(lr_schedule, quantize_moments=True, **kw)
    if kind == "adafactor":
        return adafactor(lr_schedule, **kw)
    raise ValueError(kind)

"""Train step (port of ``repro.train.train_step``): gradient accumulation
over microbatches, clipping by the global norm, then the optimizer.

The global batch [B, ...] is split into ``accum_steps`` microbatches of
B / accum rows, taken in order in a Python loop (the reference's
``lax.scan``); each microbatch's gradients come from ``torch.autograd.grad``
over the parameter leaves and accumulate in ``grad_dtype``. Nothing is
compiled: the step is eager PyTorch over the parameter tree.

Under a mesh the parameters, the optimizer's moments and the batch are
DTensors (``dist.sharding.distribute_tree``); call the step inside
``dist.sharding.use_mesh``. The gradients come back placed as their
parameters, the global norm and the clip are DTensor reductions over whole
tensors, and the returned metrics are plain tensors, the same on every
rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.dist.sharding import (full, is_dtensor, placements_of,
                                       shard)
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    max_grad_norm: float = 1.0
    grad_dtype: Any = torch.float32


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, metrics, grads) of ``loss_fn(params, *args) -> (loss,
    metrics)``: gradients of every parameter leaf (zeros where the loss does
    not reach it), each in its leaf's dtype; loss and metrics detached."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(leaves, *args)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def _microbatches(v, accum: int):
    """[B, ...] -> [accum, B / accum, ...]. A DTensor is made whole along
    B first (DTensor cannot split a sharded dim in a view) and its
    microbatches' rows are split again by the batch rule."""
    shape = (accum, v.shape[0] // accum) + tuple(v.shape[1:])
    if not is_dtensor(v):
        return v.reshape(shape)
    from torch.distributed.tensor import Replicate
    whole = [Replicate() if p.is_shard(0) else p for p in placements_of(v)]
    return shard(v.redistribute(v.device_mesh, whole).reshape(shape), None,
                 "batch")


def make_train_step(model_cfg: tfm.ModelConfig, opt: Optimizer,
                    tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``batch`` leaves (tensors or numpy arrays, moved to the
    parameters' device) have leading dim B, the global batch."""
    loss_fn = loss_fn or tfm.loss_fn
    accum = tcfg.accum_steps

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: v if is_dtensor(v) else torch.as_tensor(v, device=dev)
                 for k, v in batch.items()}
        if accum == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, model_cfg,
                                                  batch)
        else:
            mbs = {k: _microbatches(v, accum) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=tcfg.grad_dtype), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            per_mb = []
            for i in range(accum):
                loss, metrics, g = value_and_grad(
                    loss_fn, params, model_cfg,
                    {k: v[i] for k, v in mbs.items()})
                grads = tree_map(lambda a, b: a + b.to(tcfg.grad_dtype),
                                 grads, g)
                loss_sum = loss_sum + loss
                per_mb.append(metrics)
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss_sum / accum
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        out: Dict[str, torch.Tensor] = dict(metrics)
        out.update({"loss": loss, "grad_norm": gnorm})
        return params, opt_state, {k: full(v) for k, v in out.items()}

    return train_step

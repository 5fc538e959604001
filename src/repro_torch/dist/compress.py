"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (port of ``repro.dist.compress``).

Wire format per leaf: chunks of ``_CHUNK`` elements share one f32 scale
(max-abs / 127) and travel as int8 codes, so 4.03 bytes an element become
1.03. What rounding drops is not lost: the residual stays in an
error-feedback buffer and is added to the next step's gradient before
quantising (Seide et al. 1-bit SGD / DGC lineage), so the bias is O(1) per
run rather than O(steps).

``psum_int8_error_feedback`` runs on each rank's local gradients: the codes
and scales are all-gathered over one process group (one mesh dim's; the
only bytes that cross ranks), then dequantised and averaged on each rank,
in rank order, so every rank gets bitwise the same mean. As in the
reference, the train step does not call it.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.splines import true_div

Tensor = torch.Tensor

_CHUNK = 1024


def _quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Flatten, zero-pad to a _CHUNK multiple, quantise per chunk.
    Returns (codes int8 [n_chunks, _CHUNK], scale f32 [n_chunks])."""
    x = x.reshape(-1).to(torch.float32)
    pad = (-x.shape[0]) % _CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros((pad,))])
    xc = x.reshape(-1, _CHUNK)
    # one IEEE division (a CUDA tensor over a Python number would multiply
    # by the reciprocal, moving a code against the CPU's and JAX's)
    scale = true_div(torch.amax(torch.abs(xc), dim=1), 127.0)
    safe = torch.where(scale > 0, scale, 1.0)
    # torch.round is round-half-to-even, as jnp.round
    codes = torch.clamp(torch.round(xc / safe[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def _dequantize(codes: Tensor, scale: Tensor, n: int) -> Tensor:
    """Inverse of ``_quantize``; returns the first ``n`` elements, flat."""
    safe = torch.where(scale > 0, scale, 1.0)
    out = codes.to(torch.float32) * safe[:, None]
    return out.reshape(-1)[:n]


def compress_leaf(g: Tensor, ef: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Quantise ``g`` plus the carried residual ``ef`` (flat, g.numel()).
    Returns (codes, scale, new_ef, n): new_ef is exactly what this round of
    quantisation dropped and must be carried into the next call."""
    n = g.numel()
    x = g.reshape(-1).to(torch.float32) + ef.reshape(-1)[:n]
    codes, scale = _quantize(x)
    new_ef = x - _dequantize(codes, scale, n)
    return codes, scale, new_ef, n


def _leaves(tree) -> List[Tensor]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, Mapping):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, it) for v in tree]
    return next(it)


def _all_gather(t: Tensor, group, world: int) -> Tensor:
    """[world, *t.shape]: every rank's ``t``, in rank order."""
    out = t.new_empty((world * t.shape[0],) + t.shape[1:])
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.reshape((world,) + t.shape)


def psum_int8_error_feedback(grads: Any, ef: Any, group=None
                             ) -> Tuple[Any, Any]:
    """Mean-all-reduce a gradient tree (nested dicts and lists of local
    tensors) over the process ``group`` (e.g. ``mesh.get_group("data")``;
    None is the whole world) with the int8 wire format and error feedback.

    ``ef`` mirrors ``grads`` with flat f32 residual buffers (init zeros).
    Returns (averaged grads in the input shapes and dtypes, updated
    residuals)."""
    world = dist.get_world_size(group)
    outs, new_efs = [], []
    for g, e in zip(_leaves(grads), _leaves(ef)):
        codes, scale, new_e, n = compress_leaf(g, e)
        all_codes = _all_gather(codes, group, world)   # [W, chunks, _CHUNK]
        all_scale = _all_gather(scale, group, world)   # [W, chunks]
        safe = torch.where(all_scale > 0, all_scale, 1.0)
        total = (all_codes.to(torch.float32) * safe[..., None]).sum(0)
        avg = true_div(total.reshape(-1)[:n], float(world))
        outs.append(avg.reshape(g.shape).to(g.dtype))
        new_efs.append(new_e)
    return (_unflatten(grads, iter(outs)), _unflatten(ef, iter(new_efs)))

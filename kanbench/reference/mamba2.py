"""Mamba-2 (arXiv:2405.21060), the language model of stacked SSD blocks, in
plain PyTorch: float32 throughout, TF32 off, no cache and no batching: one
sequence's forward pass over all its positions at once.

The model, pre-norm and tied: ``x = embed[tokens]``; each layer adds
``block(rmsnorm(x))``; the logits are ``rmsnorm(x) @ embed.T``. The SSD
block (the paper's §7 / Fig. 6 "Mamba-2 block"):

* in-projection of the normed input to ``z`` (d_inner), ``xBC`` (d_inner
  + 2 N: the scan's input x and its B and C, one group) and ``dt`` (one a
  head);
* a causal depthwise conv1d of width ``conv_width`` over ``xBC``, then SiLU;
* the SSD over each head h, with scalar ``A_h = -exp(a_log_h)`` and
  ``dt = softplus(dt + dt_bias)``:
  ``y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < u <= t} dt_u A) dt_s x_s``,
  computed in its quadratic (attention-like) dual form, the paper's
  ``segsum`` masked and exponentiated, plus the skip ``D_h x_t``;
* the gated RMSNorm ``rmsnorm(y * silu(z))`` (norm after the gate, as
  Mamba-2's ``norm_before_gate=False``) and the out-projection.

Departures from the published model, each the program's and given to the
reference through the configuration file or the weights: no bias on the
conv (the weights carry none: a zero bias); the RMSNorm epsilon is the
file's ``rms_norm_eps`` (the published code's is 1e-5); one group of B and
C (Mamba-2-1.3b's ``ngroups`` is 1). No ``dt`` limit is applied, as the
published forward applies none by default.

The weights are made here (``make_weights``) from the seed, on the device,
in a few large draws, in the parameter tree that the program reads (one
stage of ``n_layers`` stacked repeats of one block): the benchmark hands
the same tensors to the program and to this reference. Nothing here
imports the program or JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _dims(model: Dict):
    d, di = model["d_model"], model["expand"] * model["d_model"]
    n, p = model["d_state"], model["head_dim"]
    return d, di, n, p, di // p


def make_weights(model: Dict, gen: torch.Generator) -> Dict:
    """Random float32 weights from ``gen`` on its device, scaled as the
    program initialises a layer (projections ~ N(0, 1/fan_in), conv ~ N(0,
    0.04), A = -1, softplus(dt_bias) = 1, D = 1, norm scales 1, embedding
    ~ N(0, 1/d_model)); each stacked leaf is one draw."""
    dev = gen.device
    d, di, n, _, h = _dims(model)
    L, k, v = model["n_layers"], model["conv_width"], model["vocab"]
    f32 = dict(dtype=torch.float32, device=dev)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, **f32).mul_(std)

    block = {
        "mixer_norm": {"scale": torch.ones((L, d), **f32)},
        "ssd": {
            "in_proj": randn(L, d, 2 * di + 2 * n + h, std=d ** -0.5),
            "conv": randn(L, k, di + 2 * n, std=0.2),
            "a_log": torch.zeros((L, h), **f32),
            "dt_bias": torch.full((L, h), math.log(math.e - 1), **f32),
            "d_skip": torch.ones((L, h), **f32),
            "norm": {"scale": torch.ones((L, di), **f32)},
            "out_proj": randn(L, di, d, std=di ** -0.5),
        },
    }
    if L == 1:          # a stage of one layer holds its leaves unstacked
        block = _tree(block, lambda t: t[0])
    return {"embed": randn(v, d, std=d ** -0.5),
            "final_norm": {"scale": torch.ones((d,), **f32)},
            "stages": [{"l0": block}]}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def layer(weights: Dict, model: Dict, i: int) -> Dict:
    """Layer ``i``'s leaves."""
    block = weights["stages"][0]["l0"]
    return block if model["n_layers"] == 1 else _tree(block,
                                                      lambda t: t[i])


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def segsum(a: Tensor) -> Tensor:
    """[..., T] -> [..., T, T]: ``out[..., t, s] = sum_{s < u <= t} a[u]``
    for s <= t, -inf above the diagonal (the paper's stable ``segsum``: a
    masked cumulative sum, no difference of two large sums)."""
    t = a.shape[-1]
    rep = a[..., None, :].expand(*a.shape, t).transpose(-1, -2)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device),
                       -1)
    seg = torch.cumsum(rep.masked_fill(~below, 0.0), dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~diag, -torch.inf)


def ssd(x: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
        d_skip: Tensor) -> Tensor:
    """x [T, H, P], dt [T, H] (> 0), a [H] (< 0), b, c [T, N], d_skip [H]
    -> y [T, H, P], the quadratic dual form."""
    decay = torch.exp(segsum((dt * a).transpose(0, 1)))        # [H, T, T]
    m = (c @ b.transpose(0, 1))[None] * decay                  # [H, T, S]
    u = (dt[..., None] * x).transpose(0, 1)                    # [H, S, P]
    y = torch.bmm(m, u).transpose(0, 1)                        # [T, H, P]
    return y + d_skip[None, :, None] * x


def causal_conv(u: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv: u [T, C], w [K, C]; out[t] = sum_k
    w[K-1-k] u[t-k] (zeros before the sequence)."""
    k = w.shape[0]
    return F.conv1d(u.transpose(0, 1)[None], w.transpose(0, 1)[:, None, :],
                    padding=k - 1, groups=u.shape[1])[0, :, :u.shape[0]
                                                      ].transpose(0, 1)


def block(p: Dict, x: Tensor, model: Dict) -> Tensor:
    """One SSD block on the normed input x [T, D] -> [T, D]."""
    _, di, n, hp, h = _dims(model)
    t = x.shape[0]
    z, xbc, dt = torch.split(x @ p["in_proj"], [di, di + 2 * n, h], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv"]))
    xs, b, c = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(xs.reshape(t, h, hp), dt, -torch.exp(p["a_log"]), b, c,
            p["d_skip"]).reshape(t, di)
    y = rmsnorm(y * F.silu(z), p["norm"]["scale"], model["rms_norm_eps"])
    return y @ p["out_proj"]


@torch.no_grad()
def logits(weights: Dict, model: Dict, tokens: Tensor,
           positions: Sequence[int]) -> Tensor:
    """Float32 logits [len(positions), vocab] of the sequence ``tokens``
    [T] (on the weights' device) at ``positions``: the logits at position
    t predict token t + 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = model["rms_norm_eps"]
    x = weights["embed"][tokens.long()]
    for i in range(model["n_layers"]):
        p = layer(weights, model, i)
        x = x + block(p["ssd"], rmsnorm(x, p["mixer_norm"]["scale"], eps),
                      model)
    pos = torch.as_tensor(list(positions), device=x.device)
    x = rmsnorm(x[pos], weights["final_norm"]["scale"], eps)
    return x @ weights["embed"].transpose(0, 1)

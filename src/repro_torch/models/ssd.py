"""Mamba-2 SSD (state-space duality) block, chunked parallel form (port of
``repro.models.ssd``).

y_t = C_t . h_t ,  h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t   (per head)

``ssd_chunked`` runs the hand-written kernel ``kernels/csrc/ssd_scan.cu``
on a CUDA tensor and its plain chunked form (``kernels.ref.
ssd_chunked_ref``) on a CPU tensor, both through ``kernels.ops.ssd_state``.
The oracle is the sequential recurrence ``kernels.ref.ssd_ref``.

dtypes follow the JAX package's promotion, written out: with bf16 compute
and f32 parameters, ``x @ in_proj`` is bf16 @ f32, which JAX promotes to
f32, so z, x, B, C and dt are f32 and the kernel sees f32; the mixer output
is cast to the compute dtype only once, before ``* silu(z)`` (bf16 * f32,
again f32), and the block returns f32 (the residual add casts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (as_dtensors, is_dtensor,
                                       placements_of, shard)
from repro_torch.kernels import ops
from repro_torch.models import layers

Tensor = torch.Tensor


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor,
                c_mat: Tensor, d_skip: Optional[Tensor] = None, *,
                chunk: int = 64, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """x: [B,T,H,P]; dt: [B,T,H] (>0); a: [H] (<0); b_mat/c_mat: [B,T,N].

    Returns (y [B,T,H,P], final_state [B,H,P,N]), both f32: the kernel on
    the card, the plain chunked form on the CPU.
    """
    return ops.ssd_state(x, dt, a, b_mat, c_mat, d_skip, chunk=chunk,
                         init_state=init_state)


def ssd_decode_step(state: Tensor, x_t: Tensor, dt_t: Tensor, a: Tensor,
                    b_t: Tensor, c_t: Tensor,
                    d_skip: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """One-token recurrence. state: [B,H,P,N]; x_t: [B,H,P]; dt_t: [B,H];
    b_t/c_t: [B,N]. Returns (y [B,H,P], new_state)."""
    decay = torch.exp(dt_t * a[None, :])
    upd = (dt_t[..., None] * x_t)[..., None] * b_t[:, None, None, :]
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_t)
    if d_skip is not None:
        y = y + d_skip[None, :, None] * x_t
    return y, state


# ---------------------------------------------------------------------------
# Full Mamba-2 mixer block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """The JAX config less its ``use_pallas`` flag: there the flag picked
    the Pallas kernel because a host dry-run cannot lower Mosaic. Here the
    device decides, as in every wrapper of ``kernels.ops``: the kernel on a
    CUDA tensor, the plain chunked form on a CPU tensor."""
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64
    dtype: torch.dtype = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_ssd_block(gen: Optional[torch.Generator], cfg: SSDConfig,
                   device=None) -> Dict[str, Tensor]:
    """Random block weights from ``gen`` on ``device`` (the JAX layout)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
    out_w = di * 2 + n * 2 + h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": layers.dense_init(gen, d, out_w, dtype=cfg.dtype,
                                     device=device),
        "conv": (layers.normal(gen, (cfg.conv_width, di + 2 * n), device)
                 * 0.2).to(cfg.dtype),
        "a_log": torch.zeros((h,), **f32),            # A = -exp(a_log) = -1
        "dt_bias": torch.full((h,), math.log(math.e - 1), **f32),
        "d_skip": torch.ones((h,), **f32),
        "norm": layers.init_rmsnorm(di, device),
        "out_proj": layers.dense_init(gen, di, d, dtype=cfg.dtype,
                                      device=device),
    }


def ssd_block_spec(cfg: SSDConfig) -> Dict:
    """Logical sharding names of ``init_ssd_block``'s leaves."""
    return {
        "in_proj": ("embed", "state"), "conv": ("none", "state"),
        "a_log": ("none",), "dt_bias": ("none",), "d_skip": ("none",),
        "norm": {"scale": ("none",)}, "out_proj": ("state", "embed"),
    }


def _causal_conv(u: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv via shifted adds. u: [B,T,C]; w: [K,C]. A
    DTensor input runs on each rank's shard (``_causal_conv_mesh``)."""
    if is_dtensor(u) or is_dtensor(w):
        return _causal_conv_mesh(u, w)
    return _causal_conv_plain(u, w)


def _causal_conv_mesh(u: Tensor, w: Tensor) -> Tensor:
    """The conv under ``local_map``, per mesh dim: u's batch split if it
    is (w replicated there, its gradient partial), else its channels with
    w's (the conv is depthwise), else both replicated; the time axis stays
    whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, (u, w) = as_dtensors(u, w)
    u_pl, w_pl, w_g = [], [], []
    for pu in placements_of(u):
        if pu.is_shard(0):
            col = (Shard(0), Replicate(), Partial())
        elif pu.is_shard(2):
            col = (Shard(2), Shard(1), Shard(1))
        else:
            col = (Replicate(),) * 3
        for lst, p in zip((u_pl, w_pl, w_g), col):
            lst.append(p)
    return local_map(_causal_conv_plain, out_placements=u_pl,
                     in_placements=(u_pl, w_pl), in_grad_placements=(
                         u_pl, w_g), device_mesh=mesh,
                     redistribute_inputs=True)(u, w)


def _causal_conv_plain(u: Tensor, w: Tensor) -> Tensor:
    k = w.shape[0]
    out = u * w[-1]
    for i in range(1, k):
        shifted = F.pad(u, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[-1 - i]
    return out


def ssd_inputs(params: Dict[str, Tensor], x: Tensor, cfg: SSDConfig,
               conv_hist: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """The mixer's projection, conv and gates for x [B,T,D]: ``z`` [B,T,di],
    the scan's inputs ``x`` [B,T,H,P], ``dt`` [B,T,H], ``a`` [H], ``B``/``C``
    [B,T,N] and ``d_skip`` [H], and ``conv_in`` [B,T,di+2N] (what the decode
    cache keeps). x, B and C are views of one conv output; the kernel reads
    them in place. ``conv_hist`` [B,K-1,di+2N]: the conv inputs before x
    (a chunked prefill's carried buffer); None means zeros."""
    b, t, _ = x.shape
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    # bf16 @ f32 is promoted to f32 (as JAX does): z, x, B, C, dt are f32
    zxbcdt = layers.matmul(x, params["in_proj"])
    if is_dtensor(zxbcdt):
        # the projection's columns are split over "state" in contiguous
        # shards that cut across z, x, B, C and dt: gather them before the
        # split (the reference's GSPMD reshards here too)
        from torch.distributed.tensor import Replicate
        zxbcdt = zxbcdt.redistribute(zxbcdt.device_mesh, [
            Replicate() if p.is_shard(2) or p.is_partial() else p
            for p in placements_of(zxbcdt)])
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    if conv_hist is None:
        conv_out = F.silu(_causal_conv(conv_in, params["conv"]))
    else:
        full = torch.cat([conv_hist.to(conv_in.dtype), conv_in], dim=1)
        conv_out = F.silu(_causal_conv(full, params["conv"])[
            :, conv_hist.shape[1]:])
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    return {"z": z, "x": shard(xin.reshape(b, t, h, cfg.head_dim), "batch",
                               "seq", "heads", None),
            "dt": softplus(dt.to(torch.float32) + params["dt_bias"]),
            "a": -torch.exp(params["a_log"]), "B": bmat, "C": cmat,
            "d_skip": params["d_skip"], "conv_in": conv_in}


def ssd_output(params: Dict[str, Tensor], y: Tensor, z: Tensor,
               dtype: torch.dtype) -> Tensor:
    """Gate, norm and project the scan's output y [..., di]."""
    # y rounds to the compute dtype; y * silu(z) is then bf16 * f32 -> f32,
    # and rmsnorm and out_proj stay f32 (JAX's promotion)
    y = layers.rmsnorm(params["norm"], y.to(dtype) * F.silu(z))
    return layers.matmul(y, params["out_proj"])


def apply_ssd_block(params: Dict[str, Tensor], x: Tensor, cfg: SSDConfig
                    ) -> Tensor:
    """Train/prefill path. x: [B,T,D] -> [B,T,D] f32."""
    b, t, _ = x.shape
    s = ssd_inputs(params, x, cfg)
    y, _ = ssd_chunked(s["x"], s["dt"], s["a"], s["B"], s["C"], s["d_skip"],
                       chunk=cfg.chunk)
    return ssd_output(params, y.reshape(b, t, cfg.d_inner), s["z"], x.dtype)


def init_ssd_cache(batch: int, cfg: SSDConfig, dtype=torch.float32,
                   device=None) -> Dict[str, Tensor]:
    return {
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                             dtype=torch.float32, device=device),
        "conv_buf": torch.zeros(
            (batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.d_state),
            dtype=dtype, device=device),
    }


def apply_ssd_block_decode(params: Dict[str, Tensor], x: Tensor,
                           cache: Dict[str, Tensor], cfg: SSDConfig
                           ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: [B,1,D] -> ([B,1,D], cache)."""
    b = x.shape[0]
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    zxbcdt = layers.matmul(x[:, 0], params["in_proj"])
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)           # [B, C]
    # the history is kept in the cache's dtype: at bf16 compute, decode
    # reads a rounded history where forward convolves f32 (kept, as in JAX)
    buf = cache["conv_buf"]
    hist = torch.cat([buf, conv_in[:, None, :].to(buf.dtype)], dim=1)
    w = params["conv"]                                       # [K, C]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist.to(torch.float32),
                                   w.to(torch.float32)))
    new_buf = hist[:, 1:]
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    dt = softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, state = ssd_decode_step(cache["state"],
                               xin.reshape(b, h, cfg.head_dim),
                               dt, a, bmat, cmat, params["d_skip"])
    out = ssd_output(params, y.reshape(b, di), z, x.dtype)[:, None, :]
    return out, {"state": state, "conv_buf": new_buf}

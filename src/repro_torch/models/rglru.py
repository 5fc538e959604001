"""RG-LRU recurrent block, RecurrentGemma / Griffin (port of
``repro.models.rglru``).

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

Train/prefill runs a scan over T in log2(T) doubling steps (the reference's
``jax.lax.associative_scan``; the two group the products in other trees,
which differ at float epsilon); decode is a single step carrying h. The
gates and the recurrence are f32 whatever the compute dtype. The reference
has no Pallas kernel here, and the port none either: the scan is plain
PyTorch.

The full Griffin recurrent block is: parallel linear branches (gate: GeLU;
main: causal conv1d(4) -> RG-LRU), merged by product, then output
projection. Mixed-dtype products follow JAX's promotion
(``layers.matmul``): with bf16 activations and f32 weights the branches
are f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.ssd import _causal_conv, softplus

Tensor = torch.Tensor
_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int              # lru width
    conv_width: int = 4
    dtype: torch.dtype = torch.float32


def init_rglru_block(gen: Optional[torch.Generator], cfg: RGLRUConfig,
                     device=None) -> Dict[str, Tensor]:
    """Random block weights from ``gen`` on ``device`` (the JAX layout)."""
    d, dr = cfg.d_model, cfg.d_rnn
    f32 = dict(dtype=torch.float32, device=device)
    # Lambda init so that a^c spans ~U(0.9, 0.999) (Griffin appendix)
    u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, **f32)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u/c)

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dtype=cfg.dtype,
                                 device=device)
    return {
        "w_main": dense(d, dr),
        "w_gate": dense(d, dr),
        "conv": (layers.normal(gen, (cfg.conv_width, dr), device)
                 * 0.2).to(cfg.dtype),
        "w_a": dense(dr, dr),
        "b_a": torch.zeros((dr,), **f32),
        "w_x": dense(dr, dr),
        "b_x": torch.zeros((dr,), **f32),
        "lambda": lam,
        "w_out": dense(dr, d),
    }


def rglru_block_spec(cfg: RGLRUConfig) -> Dict:
    """Logical sharding names of ``init_rglru_block``'s leaves."""
    return {"w_main": ("embed", "state"), "w_gate": ("embed", "state"),
            "conv": ("none", "state"), "w_a": ("none", "state"),
            "b_a": ("none",), "w_x": ("none", "state"), "b_x": ("none",),
            "lambda": ("none",), "w_out": ("state", "embed")}


def _gates(params, u: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, sqrt(1 - a^2) * i * u), both f32."""
    uf = u.to(torch.float32)
    r = layers.sigmoid(layers.matmul(uf, params["w_a"].to(torch.float32))
                       + params["b_a"])
    i = layers.sigmoid(layers.matmul(uf, params["w_x"].to(torch.float32))
                       + params["b_x"])
    log_a = -_C * softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, gated


def linear_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (h_{-1} = 0) over
    axis 1 in ceil(log2 T) doubling steps: after the step of distance d,
    position t holds the composition of the (up to) 2d elements ending at
    t. Returns (prod a_1..a_t, h_t)."""
    t = a.shape[1]
    d = 1
    while d < t:
        a_prev, b_prev = a[:, :t - d], b[:, :t - d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def rglru_scan(params, u: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """u: [B, T, dr] -> h: [B, T, dr] f32 via the doubling scan over T.

    ``h0`` optionally carries the hidden state from an earlier segment
    (chunked prefill): the scan's cumulative decay ``A_t = prod a_1..a_t``
    folds it in as ``h_t = A_t * h0 + h_t_local``."""
    a, b = _gates(params, u)
    a_out, h = linear_scan(a, b)
    if h0 is not None:
        h = a_out * h0.to(h.dtype)[:, None, :] + h
    return h


def rglru_step(params, u_t: Tensor, h_prev: Tensor) -> Tuple[Tensor, Tensor]:
    """u_t: [B, dr]; h_prev: [B, dr] -> (h_t, h_t)."""
    a, b = _gates(params, u_t)
    h = a * h_prev + b
    return h, h


def apply_rglru_block(params: Dict[str, Tensor], x: Tensor,
                      cfg: RGLRUConfig) -> Tensor:
    """Train/prefill. x: [B,T,D] -> [B,T,D] (f32 with f32 weights)."""
    gate = layers.gelu(layers.matmul(x, params["w_gate"]))
    main = layers.matmul(x, params["w_main"])
    main = _causal_conv(main, params["conv"])
    h = rglru_scan(params, main).to(x.dtype)
    return layers.matmul(h * gate, params["w_out"])


def init_rglru_cache(batch: int, cfg: RGLRUConfig, dtype=torch.float32,
                     device=None) -> Dict[str, Tensor]:
    return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                             device=device),
            "conv_buf": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                                    dtype=dtype, device=device)}


def apply_rglru_block_decode(params: Dict[str, Tensor], x: Tensor,
                             cache: Dict[str, Tensor], cfg: RGLRUConfig
                             ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: [B,1,D]. The conv history is kept (and joined)
    in ``conv_buf``'s dtype and convolved in f32, as in the reference: at
    bf16 the new input is rounded here where prefill convolves it in f32."""
    xt = x[:, 0]
    gate = layers.gelu(layers.matmul(xt, params["w_gate"]))
    main = layers.matmul(xt, params["w_main"])                   # [B, dr]
    hist = torch.cat([cache["conv_buf"],
                      main[:, None, :].to(cache["conv_buf"].dtype)], dim=1)
    w = params["conv"]
    main = torch.einsum("bkc,kc->bc", hist.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)
    h, _ = rglru_step(params, main, cache["h"])
    y = layers.matmul(h.to(x.dtype) * gate, params["w_out"])
    return y[:, None, :], {"h": h, "conv_buf": hist[:, 1:]}

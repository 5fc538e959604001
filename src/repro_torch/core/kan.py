"""Unified KAN execution API: backend registry + two-phase deploy/apply
(port of ``repro.core.kan``).

* **KANSpec** — one static description of a KAN stack (a single layer, an
  FFN, or the CF-KAN autoencoder).
* **register_backend(name)** — the deployment axis. Ported built-ins:
    - ``ref``   : float Cox–de Boor oracle over the dequantised artifact,
    - ``lut``   : quantised expanded-basis f32 matmul (the plain dataflow),
    - ``fused`` : the hand-written CUDA kernel ``kernels/csrc/kan_fused.cu``
                  (quantise → SH-LUT → K+1-tap contraction on chip),
    - ``cim``   : bit-sliced RRAM crossbar simulator (``hw.cim``, kernel
                  ``kernels/csrc/cim_mac.cu``) with optional KAN-SAM,
    - ``cim_tiled``: multi-tile ACIM chip simulator (``hw.tiles``/``hw.chip``,
                  kernel ``kernels/csrc/cim_mac_tiled.cu``) — per-tile IR
                  drop/ADC/variation, int32 digital partial-sum reduction,
                  empty-row compaction + within-tile KAN-SAM (``spec.cim``
                  holds a ``hw.chip.ChipConfig``),
    - ``lut_int8``: the expanded-basis contraction kept integer end to end
                  (int8 basis codes from the deploy-time int8 SH-LUT x int8
                  coefficient codes -> int32, ``torch._int_mm``), one f32
                  rescale after it.
* **deploy(params, spec, stats=None, chip_uid=0) → DeployedKAN** — done
  ONCE: int8 codes + per-output-channel scales, the SH-LUT, the bit-slice
  image and the KAN-SAM row order/attenuation, or the chip placement.
* **apply(deployed, x) → y** — run-time evaluation against the frozen
  artifact; it never requantises.
* **train_apply(params, x, spec, qat=...)** — the training twin: the same
  backend dispatch over float master weights, fake-quant/STE when
  ``qat=True``, whose forward equals the deployed integer forward. ``fused``
  trains through ``kernels.ops.kan_spline_fused``, an autograd Function
  whose forward launches the fused kernel; the integer backends train on
  the LUT path with a straight-through backward.

Parameters are plain dicts of tensors: a single unnamed layer owns
``{"coeffs", "w_base"}``; a multi-layer spec nests one such dict per layer
name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import quant, splines
from repro_torch.core.quant import ASPConfig
from repro_torch.dist.sharding import as_dtensors, placements_of
from repro_torch.obs.trace import stage


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KANLayerShape:
    """Resolved (in, out, asp) view of one layer of a KANSpec."""
    in_dim: int
    out_dim: int
    asp: ASPConfig

    @property
    def n_rows(self) -> int:
        """Crossbar rows of the expanded coefficient matrix (I * (G+K))."""
        return self.in_dim * self.asp.n_basis


@dataclasses.dataclass(frozen=True)
class KANSpec:
    """Static description of a KAN stack: ``dims = (d0, ..., dn)`` chains
    ``n`` KAN layers; ``asp`` is one ASPConfig per layer (one broadcasts)."""
    dims: Tuple[int, ...]
    asp: Tuple[ASPConfig, ...] = (ASPConfig(),)
    backend: str = "lut"
    base_activation: str = "relu"   # "" disables the b(x) residual branch
    bound_input: bool = True        # tanh-bound inputs into the knot range
    dtype: Any = torch.float32
    layer_names: Tuple[str, ...] = ()
    # cim/cim_tiled backends only: crossbar config + KAN-SAM mapping toggle
    # (cim takes a hw.cim.CIMConfig, cim_tiled a hw.chip.ChipConfig)
    cim: Any = None
    use_sam: bool = False

    def __post_init__(self):
        dims = tuple(int(d) for d in self.dims)
        if len(dims) < 2:
            raise ValueError(f"KANSpec.dims needs >= 2 entries, got {dims}")
        object.__setattr__(self, "dims", dims)
        asp = self.asp
        if isinstance(asp, ASPConfig):
            asp = (asp,)
        asp = tuple(asp)
        if len(asp) == 1:
            asp = asp * (len(dims) - 1)
        if len(asp) != len(dims) - 1:
            raise ValueError(f"{len(asp)} ASPConfigs for {len(dims)-1} layers")
        object.__setattr__(self, "asp", asp)
        names = tuple(self.layer_names)
        if names and len(names) != len(dims) - 1:
            raise ValueError(f"{len(names)} layer_names for "
                             f"{len(dims)-1} layers")
        object.__setattr__(self, "layer_names", names)

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def names(self) -> Optional[Tuple[str, ...]]:
        """Param-subtree keys; None means flat single-layer params."""
        if self.layer_names:
            return self.layer_names
        if self.n_layers == 1:
            return None
        return tuple(f"l{i}" for i in range(self.n_layers))

    def layer(self, i: int) -> KANLayerShape:
        return KANLayerShape(self.dims[i], self.dims[i + 1], self.asp[i])

    def with_backend(self, backend: str, **kw) -> "KANSpec":
        return dataclasses.replace(self, backend=backend, **kw)

    @classmethod
    def single(cls, in_dim: int, out_dim: int,
               asp: ASPConfig = ASPConfig(), **kw) -> "KANSpec":
        """One KAN layer with flat {"coeffs", "w_base"} params."""
        return cls(dims=(in_dim, out_dim), asp=(asp,), **kw)

    @classmethod
    def ffn(cls, d_model: int, hidden: int, asp: ASPConfig, **kw
            ) -> "KANSpec":
        """Transformer KAN-FFN: d_model -> hidden -> d_model (up/down)."""
        kw.setdefault("layer_names", ("up", "down"))
        return cls(dims=(d_model, hidden, d_model), asp=(asp,), **kw)


def param_count(spec: KANSpec) -> int:
    """Trainable parameter count of the spec (coeffs + base weights)."""
    n = 0
    for i in range(spec.n_layers):
        ls = spec.layer(i)
        n += ls.in_dim * ls.asp.n_basis * ls.out_dim
        if spec.base_activation:
            n += ls.in_dim * ls.out_dim
    return n


def _layer_params(params, spec: KANSpec, i: int) -> Dict[str, torch.Tensor]:
    names = spec.names
    return params if names is None else params[names[i]]


def _layer_stats(stats, spec: KANSpec, i: int):
    if stats is None:
        return None
    names = spec.names
    if names is None:
        return stats
    return stats.get(names[i]) if isinstance(stats, dict) else stats


# ---------------------------------------------------------------------------
# Shared math primitives
# ---------------------------------------------------------------------------

def bound_input(x: torch.Tensor, asp: ASPConfig) -> torch.Tensor:
    """Map pre-activations into the knot range with a scaled tanh."""
    half = 0.5 * (asp.x_max - asp.x_min)
    mid = 0.5 * (asp.x_max + asp.x_min)
    return mid + half * torch.tanh(x.to(torch.float32)).to(x.dtype)


def base_branch(x: torch.Tensor, w_base: torch.Tensor, activation: str
                ) -> torch.Tensor:
    """The b(x) residual branch: ``act(x) @ w_base``, in the promoted dtype
    as JAX computes a mixed product (bf16 x with f32 weights runs in f32)."""
    act = {"relu": torch.relu, "silu": torch.nn.functional.silu}[activation]
    rt = torch.promote_types(x.dtype, w_base.dtype)
    return act(x).to(rt) @ w_base.to(rt)


def spline_ref(x: torch.Tensor, coeffs: torch.Tensor, asp: ASPConfig
               ) -> torch.Tensor:
    """Float cardinal-B-spline oracle."""
    basis = splines.bspline_basis_uniform(
        x, asp.x_min, asp.x_max, asp.grid_size, asp.order)  # [..., I, G+K]
    return torch.einsum("...ig,igo->...o", basis, coeffs)


def spline_lut(x: torch.Tensor, coeffs: torch.Tensor, asp: ASPConfig,
               hemi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantised expanded-basis matmul over float coefficients."""
    if hemi is None:
        hemi = quant.hemi_for(asp, x.device)
    basis = quant.quantized_basis(x, hemi, asp).to(coeffs.dtype)
    lead = basis.shape[:-2]
    ik = basis.shape[-2] * basis.shape[-1]
    return basis.reshape(lead + (ik,)) @ coeffs.reshape(ik, coeffs.shape[-1])


def spline_lut_qat(x: torch.Tensor, coeffs: torch.Tensor, asp: ASPConfig,
                   hemi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantised forward with the float path's straight-through backward."""
    yq = spline_lut(x, coeffs, asp, hemi)
    yf = spline_ref(x, coeffs, asp)
    return yf + (yq - yf).detach()


# ---------------------------------------------------------------------------
# Deployed artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeployedLayer:
    """Frozen per-layer artifact — what gets programmed into the hardware."""
    codes: torch.Tensor                     # [I, S, O] int8
    scale: torch.Tensor                     # [1, 1, O] f32
    hemi: torch.Tensor                      # [ceil(L/2), K+1] f32 SH-LUT
    w_base: Optional[torch.Tensor] = None   # [I, O] residual-branch weights
    atten: Optional[torch.Tensor] = None    # [R] f32 row attenuation (cim)
    row_order: Optional[torch.Tensor] = None  # [R] int32 phys-of-logical
    slices: Optional[torch.Tensor] = None   # [I, S, O, 8] uint8 (cim)
    hemi_q: Optional[torch.Tensor] = None   # [ceil(L/2), K+1] int8 (lut_int8)
    codes_t: Optional[torch.Tensor] = None  # [O8, I*S8] int8 (lut_int8)
    tiles: Optional[Any] = None             # hw.chip.TiledLayer (cim_tiled)


@dataclasses.dataclass(frozen=True)
class DeployedKAN:
    """Frozen KAN stack artifact: produced once by ``deploy``, consumed by
    ``apply``."""
    layers: Tuple[DeployedLayer, ...]
    spec: KANSpec


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

class KANBackend:
    """One execution substrate for deployed KAN layers. Subclass, override
    ``run`` (and optionally ``deploy_extras``/``train_run``), and decorate
    with ``@register_backend(name)``."""
    name = "?"

    def deploy_extras(self, codes: torch.Tensor, scale: torch.Tensor,
                      lspec: KANLayerShape, spec: KANSpec, stats, *,
                      layer_idx: int = 0) -> Dict[str, Any]:
        """Backend-specific artifact fields (keys of DeployedLayer).
        ``layer_idx`` is a chip-unique layer id (``chip_uid * n_layers +
        layer``): cim_tiled keys its per-tile variation draw by it, so no
        two physical layers share one."""
        del codes, scale, lspec, spec, stats, layer_idx
        return {}

    def run(self, layer: DeployedLayer, lspec: KANLayerShape, spec: KANSpec,
            x: torch.Tensor, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
        """Spline forward against the frozen artifact (no requantisation)."""
        raise NotImplementedError

    def train_run(self, coeffs: torch.Tensor, lspec: KANLayerShape,
                  spec: KANSpec, x: torch.Tensor, qat: bool) -> torch.Tensor:
        """Training-path spline forward over float master coefficients.
        The default is the quantised LUT path, with the straight-through
        backward under QAT: what every integer backend trains against."""
        if qat:
            return spline_lut_qat(x, coeffs, lspec.asp)
        return spline_lut(x, coeffs, lspec.asp)


_BACKENDS: Dict[str, KANBackend] = {}


def register_backend(name: str):
    """Class/instance decorator: ``@register_backend("mine")``."""
    def deco(obj):
        inst = obj() if isinstance(obj, type) else obj
        inst.name = name
        _BACKENDS[name] = inst
        return obj
    return deco


def get_backend(name: str) -> KANBackend:
    """Registered backend instance by name (KeyError lists known names)."""
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown KAN backend {name!r}; registered backends: "
                       f"{sorted(_BACKENDS)}") from None


def backends() -> Tuple[str, ...]:
    """Sorted names of all registered backends."""
    return tuple(sorted(_BACKENDS))


@register_backend("ref")
class RefBackend(KANBackend):
    """Float basis over the dequantised artifact: accuracy ground truth."""

    def run(self, layer, lspec, spec, x, generator=None):
        coeffs = quant.dequantize_coeffs(layer.codes, layer.scale)
        return spline_ref(x, coeffs, lspec.asp)

    def train_run(self, coeffs, lspec, spec, x, qat):
        """Pure float forward (the oracle ignores ``qat``)."""
        return spline_ref(x, coeffs, lspec.asp)


@register_backend("lut")
class LutBackend(KANBackend):
    """Quantised expanded-basis f32 matmul over the int8 codes + one scale
    (the plain dataflow the fused kernel fuses)."""

    def run(self, layer, lspec, spec, x, generator=None):
        with stage("kan.basis"):
            basis = quant.quantized_basis(x, layer.hemi, lspec.asp)
        with stage("kan.mac"):
            lead = basis.shape[:-2]
            ik = basis.shape[-2] * basis.shape[-1]
            e = basis.reshape(lead + (ik,)).to(torch.float32)
            c = layer.codes.to(torch.float32).reshape(ik, -1)
            y = e @ c
            return (y * layer.scale.reshape(-1).to(torch.float32)
                    ).to(x.dtype)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_operand(c: torch.Tensor) -> torch.Tensor:
    """The int8 coefficient codes [K, N] as ``int8_matmul`` takes them:
    transposed to [N, K] and zero-padded to multiples of 8 (cuBLASLt's
    int8 product wants K and N so, and B column-major, which ``.t()`` of
    this gives)."""
    k, n = c.shape
    return torch.nn.functional.pad(c.t(), (0, _up8(k) - k, 0, _up8(n) - n)
                                   ).contiguous()


def int8_matmul(e: torch.Tensor, c_t: torch.Tensor, n: int) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> exact int32 [M, N] (``torch._int_mm``),
    B given as ``int8_operand(B)``. The rows of ``e`` are padded with zeros
    to more than 16 and a multiple of 8 and its columns to B's padded K,
    as the card wants (the product stays exact)."""
    (m, k), kp = e.shape, c_t.shape[1]
    mp = max(24, _up8(m))
    ep = torch.nn.functional.pad(e, (0, kp - k, 0, mp - m))
    return torch._int_mm(ep, c_t.t())[:m, :n]


@register_backend("lut_int8")
class LutInt8Backend(KANBackend):
    """The expanded-basis contraction stays integer end to end: int8 basis
    codes (the deploy-time int8 SH-LUT's taps, the WL-DAC view) x int8
    coefficient codes, accumulated in int32; one f32 multiply after it folds
    the coefficient scale and the basis LSB. The artifact is ``lut``'s plus
    the int8 SH-LUT; it differs from ``lut`` by the basis quantisation
    error only (<= 0.5/127 per tap). The int32 sums are exact, so they
    equal the reference's bit for bit on any device (an f32 product would
    not be exact: 2816 * 127^2 is over 2^24)."""

    def deploy_extras(self, codes, scale, lspec, spec, stats, *,
                      layer_idx=0):
        """Quantise the SH-LUT and lay out the codes for the int8 product
        once, at deploy time."""
        return {"hemi_q": quant.quantize_hemi(
                    quant.hemi_for(lspec.asp, codes.device)),
                "codes_t": int8_operand(codes.reshape(-1, codes.shape[-1]))}

    def run(self, layer, lspec, spec, x, generator=None):
        with stage("kan.basis"):
            basis = quant.quantized_basis(x, layer.hemi_q, lspec.asp)  # int8
        with stage("kan.mac"):
            lead = basis.shape[:-2]
            ik = basis.shape[-2] * basis.shape[-1]
            acc = int8_matmul(basis.reshape(-1, ik), layer.codes_t,
                              layer.codes.shape[-1]).reshape(lead + (-1,))
            lsb = torch.full((), quant.HEMI_LSB, dtype=torch.float32,
                             device=acc.device)
            y = acc.to(torch.float32) * (
                layer.scale.reshape(-1).to(torch.float32) * lsb)
            return y.to(x.dtype)


@register_backend("fused")
class FusedBackend(KANBackend):
    """The hand-written fused kernel over the artifact's int8 codes and
    SH-LUT (its plain version on the CPU)."""

    def run(self, layer, lspec, spec, x, generator=None):
        from repro_torch.kernels import ops
        with stage("kan.mac"):
            return ops.kan_spline_fused_deployed(x, layer.codes, layer.scale,
                                                 lspec.asp, hemi=layer.hemi)

    def train_run(self, coeffs, lspec, spec, x, qat):
        """The fused kernel inside its QAT autograd Function (forward
        quantised, straight-through backward), whatever ``qat``."""
        from repro_torch.kernels import ops
        return ops.kan_spline_fused(x, coeffs, lspec.asp)


@register_backend("cim")
class CimBackend(KANBackend):
    """Bit-sliced RRAM crossbar simulator (hw.cim) with optional KAN-SAM.
    Deploy freezes the bit-slice image, the per-logical-row IR-drop
    attenuation (uniform, or KAN-SAM sorted with Phase-A stats) and the
    physical row order."""

    def _cim_cfg(self, spec):
        from repro_torch.hw import cim as cim_lib
        return spec.cim if spec.cim is not None else cim_lib.CIMConfig()

    def deploy_extras(self, codes, scale, lspec, spec, stats, *,
                      layer_idx=0):
        from repro_torch.core import kan_sam
        from repro_torch.hw import cim as cim_lib
        ccfg = self._cim_cfg(spec)
        pos_att = cim_lib.row_attenuation(lspec.n_rows, ccfg, codes.device)
        out = {"slices": quant.bit_slices(codes)}
        if spec.use_sam:
            if stats is None:
                raise ValueError(
                    "KAN-SAM deploy needs Phase-A BasisStats: pass "
                    "deploy(params, spec, stats=...) with one entry per "
                    "layer name")
            c_w = kan_sam.criticality(stats, codes)
            out["row_order"], out["atten"] = kan_sam.sam_row_map(c_w, pos_att)
        else:
            out["atten"] = pos_att
        return out

    def run(self, layer, lspec, spec, x, generator=None):
        from repro_torch.hw import cim as cim_lib
        with stage("kan.basis"):
            basis = quant.quantized_basis(x, layer.hemi, lspec.asp)
            # views (no device work), inside a stage like every op
            v = basis.reshape(basis.shape[:-2] + (lspec.n_rows,))
            w = layer.codes.reshape(lspec.n_rows, lspec.out_dim)
        y = cim_lib.cim_forward(v, w, self._cim_cfg(spec),
                                atten_of_logical=layer.atten,
                                generator=generator)
        with stage("kan.mac"):
            return y * layer.scale.reshape(-1)


@register_backend("cim_tiled")
class CimTiledBackend(KANBackend):
    """Multi-tile ACIM chip simulator (hw.tiles / hw.chip).

    Deploy runs the chip mapper: empty-row compaction across tiles,
    within-tile KAN-SAM placement (``spec.use_sam`` + Phase-A stats), the
    int8 programming image and the deterministic per-``(seed, layer, tile)``
    process-variation gains, all frozen into the artifact's ``TiledLayer``.
    Run gathers word lines into physical order and reduces per-tile ADC
    readouts through the int32 adder tree (the kernel without a generator).
    """

    def _chip_cfg(self, spec):
        from repro_torch.hw import chip as chip_lib
        if spec.cim is None:
            return chip_lib.ChipConfig()
        if not isinstance(spec.cim, chip_lib.ChipConfig):
            raise TypeError(
                "the cim_tiled backend takes spec.cim = hw.chip.ChipConfig "
                f"(got {type(spec.cim).__name__}); wrap a TileConfig in "
                "ChipConfig(tile=...)")
        return spec.cim

    def deploy_extras(self, codes, scale, lspec, spec, stats, *,
                      layer_idx=0):
        from repro_torch.core import kan_sam
        from repro_torch.hw import chip as chip_lib
        crit = None
        if spec.use_sam:
            if stats is None:
                raise ValueError(
                    "KAN-SAM deploy needs Phase-A BasisStats: pass "
                    "deploy(params, spec, stats=...) with one entry per "
                    "layer name")
            crit = kan_sam.criticality(stats, codes).reshape(-1)
        tiled = chip_lib.place_layer(codes, crit, self._chip_cfg(spec),
                                     layer_uid=layer_idx)
        return {"tiles": tiled, "row_order": tiled.phys_of_logical}

    def run(self, layer, lspec, spec, x, generator=None):
        from repro_torch.hw import chip as chip_lib
        with stage("kan.basis"):
            basis = quant.quantized_basis(x, layer.hemi, lspec.asp)
            v = basis.reshape(basis.shape[:-2] + (lspec.n_rows,))
        y = chip_lib.chip_forward(v, layer.tiles, self._chip_cfg(spec),
                                  lspec.out_dim, generator=generator)
        with stage("kan.mac"):
            return y * layer.scale.reshape(-1)


# ---------------------------------------------------------------------------
# init / deploy / apply / train_apply
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, lspec: KANLayerShape, spec: KANSpec,
                device) -> Dict[str, torch.Tensor]:
    """Small-noise spline coefficients + LeCun base weights."""
    shape = (lspec.in_dim, lspec.asp.n_basis, lspec.out_dim)
    coeffs = (torch.randn(shape, generator=gen, device=gen.device)
              * (0.1 / lspec.in_dim ** 0.5))
    params = {"coeffs": coeffs.to(device=device, dtype=spec.dtype)}
    if spec.base_activation:
        w_b = (torch.randn((lspec.in_dim, lspec.out_dim), generator=gen,
                           device=gen.device) / lspec.in_dim ** 0.5)
        params["w_base"] = w_b.to(device=device, dtype=spec.dtype)
    return params


def init(seed: Union[int, torch.Generator], spec: KANSpec, *, device=None):
    """Init the param tree for a spec (flat for a bare single layer). The
    draws come from ``seed`` if it is a generator (on its own device), else
    from a CPU ``torch.Generator`` seeded with it, so a seed gives the same
    weights on every device."""
    device = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed))
    names = spec.names
    if names is None:
        return _init_layer(gen, spec.layer(0), spec, device)
    return {name: _init_layer(gen, spec.layer(i), spec, device)
            for i, name in enumerate(names)}


def deploy(params, spec: KANSpec, stats=None, *, chip_uid: int = 0
           ) -> DeployedKAN:
    """Phase 1 — build the artifact ONCE: int8 codes + per-output-channel
    scales (``quantize_coeffs(..., axis=(0, 1))``), the SH-LUT, and the
    backend's extras (cim: bit slices + KAN-SAM row order/attenuation from
    Phase-A ``stats``; cim_tiled: the chip placement and variation gains).
    The artifact lives on the params' device. An already-deployed artifact
    passes through unchanged.

    ``chip_uid`` distinguishes KAN stacks deployed onto one simulated chip:
    cim_tiled keys its variation draws by ``chip_uid * n_layers + layer``,
    so distinct physical layers draw distinct per-cell variation."""
    if isinstance(params, DeployedKAN):
        return params
    backend = get_backend(spec.backend)
    layers = []
    for i in range(spec.n_layers):
        lp = _layer_params(params, spec, i)
        lspec = spec.layer(i)
        # contiguous: the kernels take the codes in place (a refit's
        # einsum, for one, returns a permuted view)
        coeffs = lp["coeffs"].to(torch.float32).contiguous()
        codes, scale = quant.quantize_coeffs(coeffs, lspec.asp, axis=(0, 1))
        hemi = quant.hemi_for(lspec.asp, coeffs.device)
        extras = backend.deploy_extras(codes, scale, lspec, spec,
                                       _layer_stats(stats, spec, i),
                                       layer_idx=chip_uid * spec.n_layers + i)
        layers.append(DeployedLayer(
            codes=codes, scale=scale.to(torch.float32), hemi=hemi,
            w_base=lp.get("w_base"), atten=extras.get("atten"),
            row_order=extras.get("row_order"), slices=extras.get("slices"),
            hemi_q=extras.get("hemi_q"), codes_t=extras.get("codes_t"),
            tiles=extras.get("tiles")))
    return DeployedKAN(tuple(layers), spec)


@torch.no_grad()
def apply(deployed: DeployedKAN, x: torch.Tensor, *,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Phase 2 — run-time evaluation against the frozen artifact, for every
    backend. Performs no coefficient quantisation and builds no LUTs.
    ``generator`` draws the cim and cim_tiled backends' readout noise.
    A DTensor ``x`` runs on each rank's shard against the whole artifact
    (``_apply_on_shards``). While torch.profiler records, the call and its
    stages are spans of ``obs.trace`` (``kan.apply``, ``kan.basis``,
    ``kan.mac``, ``kan.base``; the crossbars' ``xbar.*``)."""
    with stage("kan.apply", x.device):
        mesh, (xd,) = as_dtensors(x)
        if mesh is not None:
            return _apply_on_shards(mesh, deployed, xd, generator)
        spec = deployed.spec
        backend = get_backend(spec.backend)
        for i, layer in enumerate(deployed.layers):
            lspec = spec.layer(i)
            xb = x
            if spec.bound_input:
                with stage("kan.basis"):
                    xb = bound_input(x, lspec.asp)
            y = backend.run(layer, lspec, spec, xb, generator=generator)
            if spec.base_activation and layer.w_base is not None:
                with stage("kan.base"):
                    y = y + base_branch(xb, layer.w_base,
                                        spec.base_activation)
            x = y
        return x


def _apply_on_shards(mesh, deployed: DeployedKAN, x, generator):
    """``apply`` under ``local_map``: per mesh dim x's rows stay split if
    they are, anything else (a split or partial feature dim) is made whole;
    every rank holds the whole artifact (as the reference replicates it
    under a mesh), so each runs the backend, the ``fused`` kernel among
    them, on its own rows."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [p if p.is_shard() and p.dim < x.ndim - 1 else Replicate()
          for p in placements_of(x)]
    return local_map(lambda xl: apply(deployed, xl, generator=generator),
                     out_placements=pl, in_placements=(pl,),
                     device_mesh=mesh, redistribute_inputs=True)(x)


def train_apply(params, x: torch.Tensor, spec: KANSpec, *, qat: bool = False
                ) -> torch.Tensor:
    """Training twin of ``apply``: float master weights through the same
    backend dispatch. With ``qat=True`` the coefficients are fake-quantised
    under a straight-through estimator, so the forward equals the deployed
    integer forward."""
    backend = get_backend(spec.backend)
    for i in range(spec.n_layers):
        lp = _layer_params(params, spec, i)
        lspec = spec.layer(i)
        xb = bound_input(x, lspec.asp) if spec.bound_input else x
        coeffs = lp["coeffs"]
        if qat:
            with torch.no_grad():
                codes, scale = quant.quantize_coeffs(coeffs, lspec.asp,
                                                     axis=(0, 1))
                cq = quant.dequantize_coeffs(codes, scale).to(coeffs.dtype)
            coeffs = coeffs + (cq - coeffs).detach()
        y = backend.train_run(coeffs, lspec, spec, xb, qat=qat)
        if spec.base_activation and "w_base" in lp:
            y = y + base_branch(xb, lp["w_base"], spec.base_activation)
        x = y
    return x


def apply_any(params_or_deployed, x: torch.Tensor, spec: KANSpec
              ) -> torch.Tensor:
    """A DeployedKAN runs the frozen integer path, a raw param tree the
    training-path forward."""
    if isinstance(params_or_deployed, DeployedKAN):
        return apply(params_or_deployed, x)
    return train_apply(params_or_deployed, x, spec)


def contains_deployed(tree) -> bool:
    """True if any subtree of ``tree`` (nested dicts and lists) is a frozen
    ``DeployedKAN``: whether a model serves the deployed path."""
    if isinstance(tree, DeployedKAN):
        return True
    if isinstance(tree, Mapping):
        return any(contains_deployed(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(contains_deployed(v) for v in tree)
    return False


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package (as numpy arrays)
# ---------------------------------------------------------------------------

_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes' bf16, as JAX gives it
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported array dtype {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree, device=None):
    """A param tree given as nested dicts and lists of numpy arrays — e.g.
    the JAX package's CF-KAN ``{"enc": {"coeffs", "w_base"}, ...}``, an LM's
    ``{"embed", "stages": [...]}`` (whisper's ``enc_stages``,
    ``enc_final_norm``, ``dec_pos`` and cross attention included) or an
    optimizer state, whose int8 moments are ``QTensor(codes, scale)``
    named tuples — moved to numpy — as the port's tree of tensors on
    ``device`` (bf16 arrays become bf16 tensors, a ``QTensor`` the port's
    ``optim.QTensor``)."""
    device = resolve_device(device)
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == (
            "codes", "scale"):
        from repro_torch.optim.optimizers import QTensor
        return QTensor(*(params_from_numpy(v, device) for v in tree))
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _to_tensor(tree, device)


def deployed_from_numpy(layers: Sequence[Mapping], spec: KANSpec,
                        device=None) -> DeployedKAN:
    """A deployed artifact from per-layer mappings of DeployedLayer field
    names to numpy arrays (or None) — e.g. a JAX ``DeployedKAN``'s layers —
    so both packages can serve one identical artifact. A ``tiles`` entry is
    itself a mapping of ``hw.chip.TiledLayer`` field names to arrays (its
    gains included). A ``lut_int8`` artifact without ``codes_t`` (JAX's has
    none) gets it from its codes."""
    from repro_torch.hw import chip as chip_lib
    device = resolve_device(device)
    fields = [f.name for f in dataclasses.fields(DeployedLayer)]
    out = []
    for layer in layers:
        kw = {f: _to_tensor(layer[f], device) for f in fields
              if f != "tiles" and layer.get(f) is not None}
        if layer.get("tiles") is not None:
            kw["tiles"] = chip_lib.TiledLayer(**{
                k: None if a is None else _to_tensor(a, device)
                for k, a in layer["tiles"].items()})
        if "hemi_q" in kw and "codes_t" not in kw:
            codes = kw["codes"]
            kw["codes_t"] = int8_operand(codes.reshape(-1, codes.shape[-1]))
        out.append(DeployedLayer(**kw))
    return DeployedKAN(tuple(out), spec)

"""CF-KAN: KAN-based collaborative-filtering autoencoder (paper §4; port of
``repro.models.cf_kan``).

An encoder–decoder of two KAN layers over user→item interaction vectors,
trained with a multinomial likelihood (QAT through ``kan.train_apply``) and
scored by Recall@k / NDCG@k. Every fidelity runs through ``core.kan``: the
training-path forward via ``kan.train_apply``, serving via ``kan.deploy`` →
``kan.apply`` on the ``fused`` backend or the ``cim`` crossbar simulator
(uniform or KAN-SAM row mapping).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.core import kan, kan_sam
from repro_torch.core.quant import ASPConfig
from repro_torch.hw import cim
from repro_torch.obs.trace import stage


@dataclasses.dataclass(frozen=True)
class CFKANConfig:
    n_items: int
    hidden: int
    asp_enc: ASPConfig
    asp_dec: ASPConfig
    backend: str = "lut"
    name: str = "cf-kan"

    @property
    def kan_spec(self) -> kan.KANSpec:
        return kan.KANSpec(
            dims=(self.n_items, self.hidden, self.n_items),
            asp=(self.asp_enc, self.asp_dec),
            backend=self.backend, layer_names=("enc", "dec"))

    @property
    def n_params(self) -> int:
        return kan.param_count(self.kan_spec)

    def with_grids(self, g_enc: int, g_dec: int) -> "CFKANConfig":
        return dataclasses.replace(self, asp_enc=self.asp_enc.with_grid(g_enc),
                                   asp_dec=self.asp_dec.with_grid(g_dec))


def init(seed: Union[int, torch.Generator], cfg: CFKANConfig, *,
         device=None) -> Dict:
    """Random CF-KAN weights from a seed (``device=None``: the card)."""
    return kan.init(seed, cfg.kan_spec, device=device)


def apply(params: Dict, x: torch.Tensor, cfg: CFKANConfig, *,
          qat: bool = False) -> torch.Tensor:
    """x: [B, n_items] interaction vector -> item logits (training-path
    forward over float weights; fake-quantised under ``qat``)."""
    return kan.train_apply(params, x, cfg.kan_spec, qat=qat)


def deploy(params: Dict, cfg: CFKANConfig, *,
           cim_cfg: Optional[cim.CIMConfig] = None, use_sam: bool = False,
           stats: Optional[Dict[str, kan_sam.BasisStats]] = None
           ) -> kan.DeployedKAN:
    """One-shot serving artifact. With ``cim_cfg`` the backend is the
    crossbar simulator (KAN-SAM mapping when ``use_sam``, needing Phase-A
    ``stats`` keyed {"enc", "dec"})."""
    spec = cfg.kan_spec
    if cim_cfg is not None:
        spec = spec.with_backend("cim", cim=cim_cfg, use_sam=use_sam)
    return kan.deploy(params, spec, stats=stats)


def apply_cim(params: Dict, x: torch.Tensor, cfg: CFKANConfig,
              cim_cfg: cim.CIMConfig, *, use_sam: bool = False,
              stats: Optional[Dict[str, kan_sam.BasisStats]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """CIM-simulated forward: deploy onto the crossbar, then apply."""
    deployed = deploy(params, cfg, cim_cfg=cim_cfg, use_sam=use_sam,
                      stats=stats)
    return kan.apply(deployed, x, generator=generator)


@torch.no_grad()
def collect_layer_stats(params: Dict, batches, cfg: CFKANConfig
                        ) -> Dict[str, kan_sam.BasisStats]:
    """Phase A of Algorithm 1 for both layers (encoder inputs are data;
    decoder inputs are encoder outputs)."""
    spec = cfg.kan_spec
    enc_spec = kan.KANSpec.single(cfg.n_items, cfg.hidden, cfg.asp_enc,
                                  backend=cfg.backend)
    device = params["enc"]["coeffs"].device
    s_enc = kan_sam.init_stats(cfg.n_items, cfg.asp_enc, device)
    s_dec = kan_sam.init_stats(cfg.hidden, cfg.asp_dec, device)
    for x in batches:
        xb = kan.bound_input(x, cfg.asp_enc) if spec.bound_input else x
        s_enc = kan_sam.update_stats(s_enc, xb, cfg.asp_enc)
        h = kan.train_apply(params["enc"], x, enc_spec)
        hb = kan.bound_input(h, cfg.asp_dec) if spec.bound_input else h
        s_dec = kan_sam.update_stats(s_dec, hb, cfg.asp_dec)
    return {"enc": s_enc, "dec": s_dec}


# --- loss & metrics ------------------------------------------------------------

def multinomial_loss(params: Dict, x: torch.Tensor, cfg: CFKANConfig,
                     qat: bool = False) -> torch.Tensor:
    """Mult-VAE style: minus the softmax log-likelihood of the observed
    interactions, summed per user and averaged over the batch."""
    logp = torch.log_softmax(apply(params, x, cfg, qat=qat), dim=-1)
    return -torch.mean(torch.sum(logp * x, dim=-1))


def _top_k(scores: torch.Tensor, observed: torch.Tensor, k: int
           ) -> torch.Tensor:
    """Indices of the k best unobserved scores; ties go to the lower index
    (as ``jax.lax.top_k``), which ``torch.topk`` does not promise. The
    ``cf_kan.rank`` stage of ``obs.trace``."""
    with stage("cf_kan.rank"):
        scores = torch.where(observed > 0, -torch.inf, scores)
        return torch.sort(scores, dim=-1, descending=True,
                          stable=True)[1][..., :k]


def recall_at_k(scores: torch.Tensor, held_out: torch.Tensor,
                observed: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Recall@k: fraction of held-out items in the top-k unobserved scores."""
    topk = _top_k(scores, observed, k)
    hits = torch.gather(held_out, -1, topk).sum(-1)
    denom = torch.clamp(held_out.sum(-1), max=k)
    return torch.mean(torch.where(
        denom > 0, hits / torch.clamp(denom, min=1), 0.0))


def ndcg_at_k(scores: torch.Tensor, held_out: torch.Tensor,
              observed: torch.Tensor, k: int = 20) -> torch.Tensor:
    topk = _top_k(scores, observed, k)
    gains = torch.gather(held_out, -1, topk)
    discounts = 1.0 / torch.log2(torch.arange(
        2, k + 2, dtype=torch.float32, device=scores.device))
    dcg = (gains * discounts).sum(-1)
    n_rel = torch.clamp(held_out.sum(-1), max=k).to(torch.int64)
    ideal = torch.cumsum(discounts, dim=0)
    idcg = torch.where(n_rel > 0, ideal[torch.clamp(n_rel - 1, min=0)], 1.0)
    return torch.mean(torch.where(n_rel > 0, dcg / idcg, 0.0))

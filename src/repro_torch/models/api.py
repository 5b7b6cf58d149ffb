"""Model facade: the port of ``repro.models.api`` for the dense family.

`Model` exposes what the serving launcher needs:
  specs()                        -> ParamSpec tree (no allocation)
  init(seed)                     -> params on the model's device
  forward(params, batch)         (prefill: runs the flash_attention kernel)
  decode_step(params, cache, tokens)
  cache_specs(batch, seq) / init_cache(batch, seq)

Training (``loss``) waits for the training slice (ROADMAP A14).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr
from repro_torch.models.layers import init_tree


@dataclass
class Model:
    cfg: ArchConfig
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    device: str | torch.device | None = "cuda"

    def __post_init__(self):
        tr.check_family(self.cfg)
        self.device = resolve_device(self.device)

    # -- params --------------------------------------------------------------
    def specs(self):
        return tr.lm_specs(self.cfg, self.param_dtype)

    def init(self, seed: int = 0):
        """Random parameters drawn on the model's device from ``seed``."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return init_tree(self.specs(), g, self.device)

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch, last_only: bool = False):
        """Full-sequence logits (prefill step); last_only slices before the
        unembed so serving never materialises (B, S, V)."""
        return tr.lm_forward(self.cfg, params, batch["tokens"],
                             dtype=self.compute_dtype, last_only=last_only)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token per sequence; the cache is updated in place."""
        return tr.lm_decode_step(self.cfg, params, cache, tokens,
                                 dtype=self.compute_dtype)

    def cache_specs(self, batch: int, seq_len: int):
        return tr.init_cache_specs(self.cfg, batch, seq_len,
                                   self.compute_dtype)

    def init_cache(self, batch: int, seq_len: int):
        return tr.init_cache(self.cfg, batch, seq_len, self.compute_dtype,
                             self.device)


def build_model(cfg: ArchConfig, *, device="cuda", **kw) -> Model:
    return Model(cfg, device=device, **kw)

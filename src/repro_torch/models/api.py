"""Model facade: the port of ``repro.models.api`` for the dense, SSM and
hybrid families.

`Model` exposes what the trainer and the serving launcher need:
  specs()                        -> ParamSpec tree (no allocation)
  init(seed)                     -> params on the model's device
  loss(params, batch)            (train: differentiable; on a card its
                                  attention gradient runs the
                                  flash_attention backward kernels)
  forward(params, batch)         (prefill: runs the flash_attention and
                                  ssd_scan kernels)
  decode_step(params, cache, tokens)
  cache_specs(batch, seq) / init_cache(batch, seq)
  input_specs(shape)             -> TensorSpec stand-ins of a step's inputs
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tr
from repro_torch.models.layers import TensorSpec, init_tree


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

    # -- training ------------------------------------------------------------
    def loss(self, params, batch):
        """(loss, {"ce", "zloss", "aux"}) of a (B, S) token batch; autograd
        records it when the parameters require gradients."""
        return tr.lm_loss(self.cfg, params, batch,
                          dtype=self.compute_dtype)

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch, last_only: bool = False):
        """Full-sequence logits (prefill step); last_only slices before the
        unembed so serving never materialises (B, S, V)."""
        return tr.lm_forward(self.cfg, params, batch["tokens"],
                             dtype=self.compute_dtype,
                             last_only=last_only)[0]

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

    # -- abstract inputs -----------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """TensorSpec stand-ins for every model input of this shape: (B, S)
        int32 tokens for train and prefill shapes, (B,) for decode."""
        b = shape.global_batch
        if shape.kind in ("train", "prefill"):
            return {"tokens": TensorSpec((b, shape.seq_len), torch.int32)}
        return {"tokens": TensorSpec((b,), torch.int32)}


def build_model(cfg: ArchConfig, *, device="cuda", **kw) -> Model:
    return Model(cfg, device=device, **kw)

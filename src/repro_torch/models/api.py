"""Model facade: the port of ``repro.models.api``, family-dispatched over
every family of the registry (dense, MoE, SSM, hybrid, VLM and enc-dec).

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

A batch is ``{"tokens"}``, with ``"embeds"`` (B, frontend_tokens, D) for
the VLM and ``"frames"`` (B, encoder_seq, D) for the enc-dec family.

On a mesh (parameters placed by the sharding rules), ``loss``,
``forward`` and ``decode_step`` compute each product on this rank's
``model`` shards where the rules split a layer over ``model``
(``sharding/tp.py``); the decode step then takes this rank's
``cache_pspecs`` shard of the cache (``StepBundle.init_cache``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tr
from repro_torch.models.layers import TensorSpec, init_tree, shapes_tree

FAMILIES = tr.PORTED + ("encdec",)


@dataclass
class Model:
    cfg: ArchConfig
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # the reference's layer-scan unroll (exact dry-run cost accounting):
    # accepted, with no effect -- the port's layer loops run eagerly
    unroll: bool = False
    device: str | torch.device | None = "cuda"

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"{self.cfg.name}: unknown family "
                             f"{self.cfg.family!r}, not one of {FAMILIES}")
        self.device = resolve_device(self.device)

    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    # -- params --------------------------------------------------------------
    def specs(self):
        if self.encdec:
            return encdec_lib.encdec_specs(self.cfg, self.param_dtype)
        return tr.lm_specs(self.cfg, self.param_dtype)

    def init(self, seed: int = 0, *, mesh=None, placements=None):
        """Random parameters drawn on the model's device from ``seed``;
        with a ``mesh``, each leaf placed by ``placements`` as it is drawn
        (``layers.init_tree``)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return init_tree(self.specs(), g, self.device, mesh=mesh,
                         placements=placements)

    def abstract_params(self):
        return shapes_tree(self.specs())

    # -- training ------------------------------------------------------------
    def loss(self, params, batch):
        """(loss, metrics) of a batch -- {"ce", "zloss", "aux"}, or {"ce"}
        for the enc-dec family; autograd records it when the parameters
        require gradients."""
        if self.encdec:
            return encdec_lib.encdec_loss(self.cfg, params, batch,
                                          dtype=self.compute_dtype)
        return tr.lm_loss(self.cfg, params, batch,
                          dtype=self.compute_dtype)

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch, last_only: bool = False):
        """Full-sequence logits (prefill step); last_only slices before the
        unembed so serving never materialises (B, S, V)."""
        if self.encdec:
            enc = encdec_lib.encode(self.cfg, params, batch["frames"],
                                    dtype=self.compute_dtype)
            return encdec_lib.decode_train(self.cfg, params, batch["tokens"],
                                           enc, dtype=self.compute_dtype,
                                           last_only=last_only)
        return tr.lm_forward(self.cfg, params, batch["tokens"],
                             batch.get("embeds"), dtype=self.compute_dtype,
                             last_only=last_only)[0]

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """One token per sequence; the cache is updated in place.  The
        enc-dec cache needs its cross K/V first
        (``encdec.precompute_cross_kv``)."""
        if self.encdec:
            return encdec_lib.encdec_decode_step(self.cfg, params, cache,
                                                 tokens,
                                                 dtype=self.compute_dtype)
        return tr.lm_decode_step(self.cfg, params, cache, tokens,
                                 dtype=self.compute_dtype)

    def cache_specs(self, batch: int, seq_len: int):
        if self.encdec:
            return encdec_lib.encdec_cache_specs(self.cfg, batch, seq_len,
                                                 self.compute_dtype)
        return tr.init_cache_specs(self.cfg, batch, seq_len,
                                   self.compute_dtype)

    def init_cache(self, batch: int, seq_len: int):
        """Zero tensors, ``pos_buf`` all -1 (the empty sentinel), ``cur``
        0."""
        return tr.cache_of(self.cache_specs(batch, seq_len), self.device)

    # -- abstract inputs -----------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """TensorSpec stand-ins for every model input of this shape: (B, S)
        int32 tokens for train and prefill shapes (the VLM's S less its
        frontend positions, which come as embeds; the enc-dec family's
        frames beside them), (B,) for decode."""
        cfg = self.cfg
        b = shape.global_batch
        if shape.kind not in ("train", "prefill"):
            return {"tokens": TensorSpec((b,), torch.int32)}
        s = shape.seq_len
        if self.encdec:
            return {"tokens": TensorSpec((b, s), torch.int32),
                    "frames": TensorSpec((b, cfg.encoder_seq, cfg.d_model),
                                         self.compute_dtype)}
        if cfg.frontend == "none":
            return {"tokens": TensorSpec((b, s), torch.int32)}
        return {"tokens": TensorSpec((b, s - cfg.frontend_tokens),
                                     torch.int32),
                "embeds": TensorSpec((b, cfg.frontend_tokens, cfg.d_model),
                                     self.compute_dtype)}


def build_model(cfg: ArchConfig, *, device="cuda", **kw) -> Model:
    return Model(cfg, device=device, **kw)

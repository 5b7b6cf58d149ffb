"""Config system of the PyTorch port: a copy of ``repro.configs.base``.

The port may not import the JAX package, so it keeps its own copy of
this pure-data module; ``tests/test_torch_models.py`` holds every arch's
shapes and parameter count equal to the reference's.

Every architecture is a frozen dataclass (`ArchConfig`) carrying the exact
published hyper-parameters plus a *sharding plan* describing how the arch is
laid out on the production mesh.  Input shapes are `ShapeConfig`s; the cross
product (arch x shape) with applicability filtering gives the dry-run cells.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Tuple

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (seq_len x global_batch, and what it lowers)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Sharding plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingPlan:
    """How an arch maps onto the (pod, data, model) production mesh.

    mode:
      "fsdp_tp"  - params 2-D sharded: FSDP over `data`, TP over `model`.
      "dp_only"  - params replicated; batch sharded over data x model jointly
                   (right answer for sub-2B models on a 256-chip pod).
    moe_mode:
      "ep" - experts sharded over `model` (expert parallelism, all-to-all)
      "tp" - experts replicated over `model`; expert FFN hidden dim TP-sharded
    """

    mode: str = "fsdp_tp"
    moe_mode: str = "tp"
    # shard KV cache heads over `model` when divisible, else sequence:
    decode_kv_shard: str = "auto"  # "heads" | "seq" | "auto" | "replicated"
    remat: str = "full"  # "none" | "dots" | "full" - activation ckpt policy
    # gradient-accumulation microbatches for train shapes (activation memory
    # = one microbatch; the production lever that fits 104B x 4k on v5e).
    microbatches: int = 1
    # pin decode KV attention to the cache's sequence sharding (avoids the
    # SPMD involuntary-remat reshard on GQA archs whose kv heads don't
    # divide the model axis); perf-hillclimb lever.
    decode_seq_constraint: bool = False
    # beyond-paper knobs used by the perf hillclimb:
    gradient_compression: bool = False
    pipeline_pods: bool = False  # map the pod axis to pipeline stages


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attn_out_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"  # "silu" (gated) | "gelu" (plain, whisper)
    sliding_window: int = 0  # 0 -> full attention; >0 -> SWA window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # hybrid (zamba2): shared attention block applied every `hybrid_period` layers
    hybrid_period: int = 0
    # enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 1_500  # whisper 30s @ 50Hz after conv stub
    # modality frontend stub: "none" | "vision" | "audio"
    frontend: str = "none"
    frontend_tokens: int = 0  # patch/frame embeddings prepended in train
    # shapes/applicability
    sub_quadratic: bool = False  # may run long_500k
    has_decoder: bool = True  # encoder-only archs skip decode shapes
    plan: ShardingPlan = field(default_factory=ShardingPlan)
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 (16-way TP x 128 MXU lanes);
        tiny (reduced/smoke) vocabs only pad to 128."""
        mult = 2048 if self.vocab_size >= 16_384 else 128
        return int(math.ceil(self.vocab_size / mult) * mult)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) -------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            p = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
            if self.qkv_bias:
                p += n_q * h + 2 * n_kv * h
            return p

        def dense_ffn(dff: int) -> int:
            if self.act == "gelu":
                return 2 * d * dff + dff + d  # w1, w2 + biases (whisper)
            return 3 * d * dff  # gated silu: wi, wg, wo

        def moe_ffn() -> int:
            experts = self.n_experts if not active_only else self.top_k
            return experts * 3 * d * self.d_ff + d * self.n_experts  # + router

        def ssd_block() -> int:
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_n_heads
            in_proj = d * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
            conv = self.ssm_conv_width * (di + 2 * ns)
            out = di * d
            return in_proj + conv + out + 2 * nh  # + A_log, D

        per_layer_norms = 2 * d
        if self.family == "ssm":
            layer = ssd_block() + d
            return emb + self.num_layers * layer + d
        if self.family == "hybrid":
            m_layers = self.num_layers
            shared = attn_params() + dense_ffn(self.d_ff) + per_layer_norms
            return emb + m_layers * (ssd_block() + d) + shared + d
        if self.family == "encdec":
            enc = self.encoder_layers * (
                attn_params() + dense_ffn(self.d_ff) + per_layer_norms
            )
            dec = self.num_layers * (
                2 * attn_params() + dense_ffn(self.d_ff) + 3 * d
            )
            return emb + enc + dec + 2 * d
        ffn = moe_ffn() if self.is_moe else dense_ffn(self.d_ff)
        layer = attn_params() + ffn + per_layer_norms
        extra = self.frontend_tokens * d if self.frontend != "none" else 0
        return emb + self.num_layers * layer + d + extra

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    # -- smoke-test reduction ----------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kv_ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
        n_heads = 4
        n_kv = max(1, n_heads // kv_ratio)
        changes = dict(
            num_layers=2,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            frontend_tokens=8 if self.frontend != "none" else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.family == "encdec" else self.encoder_seq,
            sliding_window=8 if self.sliding_window else 0,
            n_experts=4 if self.n_experts else 0,
            top_k=min(2, self.top_k) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 256,
            hybrid_period=2 if self.hybrid_period else 0,
            plan=ShardingPlan(mode="dp_only", moe_mode=self.plan.moe_mode,
                              remat="none"),
        )
        return replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for one dry-run cell."""
    if shape.kind == "decode" and not arch.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "500k decode needs sub-quadratic attention (DESIGN.md §6)"
    return True, ""


def dryrun_cells() -> list[tuple[ArchConfig, ShapeConfig, bool, str]]:
    """All 40 (arch x shape) cells with applicability flags."""
    import repro_torch.configs.archs  # noqa: F401  (populate registry)

    cells = []
    for name in list_archs():
        arch = get_arch(name)
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape)
            cells.append((arch, shape, ok, why))
    return cells

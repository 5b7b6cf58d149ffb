"""qwen2-1.5b: dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

QWEN2_1_5B = register(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    # 1.5B: DP-dominant; big vocab stays sharded via dp_only's vocab rule.
    plan=ShardingPlan(mode="dp_only", remat="dots"),
    source="arXiv:2407.10671",
))

"""mixtral-8x22b: MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=32_768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,  # SWA per assignment -> sub-quadratic, runs long_500k
    sub_quadratic=True,
    rope_theta=1_000_000.0,
    # 8 experts < 16 model shards -> TP within experts (d_ff 16384/16 = 1024).
    plan=ShardingPlan(microbatches=8, mode="fsdp_tp", moe_mode="tp", remat="full"),
    source="arXiv:2401.04088",
))

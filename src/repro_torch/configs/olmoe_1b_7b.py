"""olmoe-1b-7b: MoE 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

OLMOE_1B_7B = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    n_experts=64,
    top_k=8,
    rope_theta=10_000.0,
    # 64 experts / 16 model shards = 4 per shard -> true expert parallelism.
    plan=ShardingPlan(microbatches=4, mode="fsdp_tp", moe_mode="ep", remat="dots"),
    source="arXiv:2409.02060",
))

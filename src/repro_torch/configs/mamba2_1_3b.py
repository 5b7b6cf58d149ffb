"""mamba2-1.3b: attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

MAMBA2_1_3B = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,             # pure Mamba2 blocks, no MLP
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,    # d_inner 4096 / 64 = 64 SSD heads
    ssm_chunk=256,
    sub_quadratic=True,  # O(1) decode state -> runs long_500k
    plan=ShardingPlan(microbatches=4, mode="fsdp_tp", remat="dots"),
    source="arXiv:2405.21060 (unverified)",
))

"""zamba2-2.7b: hybrid Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

ZAMBA2_2_7B = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,       # Mamba2 layers
    d_model=2560,
    n_heads=32,          # shared attention block
    n_kv_heads=32,
    d_ff=10_240,         # shared block MLP
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_period=6,     # shared block applied every 6 Mamba2 layers
    sub_quadratic=True,  # SSM backbone; shared attn sees a bounded window
    sliding_window=4096, # bound for the shared attention block at long ctx
    plan=ShardingPlan(microbatches=4, mode="fsdp_tp", remat="dots"),
    source="arXiv:2411.15242",
))

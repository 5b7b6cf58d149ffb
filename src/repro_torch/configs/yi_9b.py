"""yi-9b: llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

YI_9B = register(ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=10_000.0,
    plan=ShardingPlan(microbatches=4, mode="fsdp_tp", remat="dots",
                      decode_seq_constraint=True),
    source="arXiv:2403.04652",
))

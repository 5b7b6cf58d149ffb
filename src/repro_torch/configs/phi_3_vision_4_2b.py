"""phi-3-vision-4.2b: phi3-mini backbone + CLIP patch-embedding stub
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

PHI_3_VISION_4_2B = register(ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    rope_theta=10_000.0,
    frontend="vision",
    frontend_tokens=576,  # 24x24 CLIP patch embeddings, precomputed stub
    plan=ShardingPlan(microbatches=4, mode="fsdp_tp", remat="dots"),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
))

"""smollm-135m: llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

SMOLLM_135M = register(ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49_152,
    tie_embeddings=True,
    # 135M params on a 256-chip pod: TP would be collective-bound; pure DP.
    plan=ShardingPlan(mode="dp_only", remat="none"),
    source="hf:HuggingFaceTB/SmolLM-135M",
))

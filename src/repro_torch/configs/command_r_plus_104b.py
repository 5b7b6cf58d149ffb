"""command-r-plus-104b: large dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

COMMAND_R_PLUS_104B = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33_792,
    vocab_size=256_000,
    tie_embeddings=True,  # cohere ties input/output embeddings
    rope_theta=75_000_000.0,
    plan=ShardingPlan(microbatches=16, mode="fsdp_tp", remat="full",
                      decode_seq_constraint=True),
    source="hf:CohereForAI/c4ai-command-r-v01 (unverified)",
))

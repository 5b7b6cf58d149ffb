"""whisper-medium: enc-dec with conv frontend stub [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig, ShardingPlan, register

WHISPER_MEDIUM = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,        # decoder layers
    encoder_layers=24,
    encoder_seq=1500,     # 30 s audio @ 50 Hz after the (stubbed) conv frontend
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,    # padded to 53_248 for 16-way TP (base.padded_vocab)
    act="gelu",           # whisper uses plain GELU MLPs with biases
    frontend="audio",
    plan=ShardingPlan(mode="dp_only", remat="dots"),
    source="arXiv:2212.04356 (unverified)",
))

"""The port's data sources: the synthetic LM token pipeline and the
Marconi100-style job-trace synthesiser."""
from repro_torch.data.m100 import synthesize_m100_trace
from repro_torch.data.tokens import TokenPipeline, synthetic_batch

__all__ = ["TokenPipeline", "synthetic_batch", "synthesize_m100_trace"]

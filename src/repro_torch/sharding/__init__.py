"""Sharding of the port: logical axes -> mesh axes (``rules``), and the
training state placed by them as DTensors (``fsdp``)."""
from repro_torch.sharding.rules import (MeshRules, P, PartitionSpec,
                                        axis_sizes, placements)

__all__ = ["MeshRules", "P", "PartitionSpec", "axis_sizes", "placements"]

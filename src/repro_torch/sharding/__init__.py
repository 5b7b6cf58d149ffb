"""Sharding rules of the port: logical axes -> mesh axes (``rules``)."""
from repro_torch.sharding.rules import (MeshRules, P, PartitionSpec,
                                        axis_sizes, placements)

__all__ = ["MeshRules", "P", "PartitionSpec", "axis_sizes", "placements"]

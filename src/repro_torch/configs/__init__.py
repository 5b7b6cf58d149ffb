from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeConfig,
    ShardingPlan,
    dryrun_cells,
    get_arch,
    list_archs,
    shape_applicable,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "ShardingPlan",
    "dryrun_cells",
    "get_arch",
    "list_archs",
    "shape_applicable",
]


def _load() -> None:
    import repro_torch.configs.archs  # noqa: F401


_load()

from repro_torch.configs.base import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    PORTED_ARCHS,
    ArchConfig,
    ShapeConfig,
    all_configs,
    applicable_shapes,
    get_config,
    get_shape,
)

__all__ = [
    "ASSIGNED_ARCHS",
    "INPUT_SHAPES",
    "PORTED_ARCHS",
    "ArchConfig",
    "ShapeConfig",
    "all_configs",
    "applicable_shapes",
    "get_config",
    "get_shape",
]

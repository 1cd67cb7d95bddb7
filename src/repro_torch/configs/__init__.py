from repro_torch.configs.base import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    PORT_ONLY_ARCHS,
    PORT_ONLY_FIELDS,
    PORTED_ARCHS,
    ArchConfig,
    ShapeConfig,
    all_configs,
    applicable_shapes,
    get_config,
    get_shape,
    reference_view,
)

__all__ = [
    "ASSIGNED_ARCHS",
    "INPUT_SHAPES",
    "PORT_ONLY_ARCHS",
    "PORT_ONLY_FIELDS",
    "PORTED_ARCHS",
    "ArchConfig",
    "ShapeConfig",
    "all_configs",
    "applicable_shapes",
    "get_config",
    "get_shape",
    "reference_view",
]

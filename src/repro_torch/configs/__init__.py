from repro_torch.configs.base import (
    ASSIGNED_ARCHS,
    PORTED_ARCHS,
    ArchConfig,
    get_config,
)

__all__ = [
    "ASSIGNED_ARCHS",
    "PORTED_ARCHS",
    "ArchConfig",
    "get_config",
]

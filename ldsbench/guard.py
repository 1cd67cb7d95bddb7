"""The run's check that no JAX and no JAX package is loaded: top-level
module names (the part before the first dot) are compared whole, so
``repro_torch`` passes where ``repro`` does not."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})

"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """CUDA (every entry point's default) must exist: an entry point never
    falls back to the CPU unless the caller asks for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev

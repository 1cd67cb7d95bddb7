"""The one dispatch point per kernel (the port's counterpart of the JAX
package's ``kernels/ops.py``). Each takes the model layout; a CPU tensor
runs the plain PyTorch version, a CUDA tensor the hand-written kernel."""
from __future__ import annotations

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_decode_attention_int8,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import int8_matmul, quantize_int8
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.topk_sample import (
    path_rows,
    reset_path_rows,
    sample_tokens,
    topk_sample,
)

__all__ = ["LAUNCHES", "decode_attention", "flash_attention", "int8_matmul",
           "paged_decode_attention", "paged_decode_attention_int8",
           "path_rows", "quantize_int8", "reset_launches", "rglru_scan",
           "sample_tokens", "topk_sample"]


def reset_launches():
    """Every kernel's launch count, and the sampler's rows by path, to 0."""
    build.reset_launches()
    reset_path_rows()

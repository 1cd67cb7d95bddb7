"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). All sources
compile in parallel, one ``nvcc`` each, into ``kernels/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of every source and header, so
an edited source rebuilds and an unchanged one loads at once. Nothing is
built when this module is imported: ``load()`` builds on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention", "paged_decode_attention",
           "paged_decode_attention_int8", "decode_attention", "int8_matmul",
           "rglru_scan", "sampling", "ssd_step", "moe_grouped")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

#: C signature of every entry point: (library, argtypes); all return int
#: (a cudaError_t, 0 on success; ``paged_decode_sm90_smem`` and
#: ``sample_tokens_static_smem``: bytes; ``sample_tokens_max_clusters`` and
#: ``paged_decode_*twin_blocks_per_sm``: a count).
SIGNATURES = {
    "flash_attention_f32": ("flash_attention",
                            [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P]),
    "flash_attention_bf16": ("flash_attention",
                             [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P]),
    "paged_decode_attention_f32": (
        "paged_decode_attention",
        [_P] * 9 + [_I] * 7 + [_L] * 3 + [_I, _F, _P]),
    "paged_decode_attention_bf16": (
        "paged_decode_attention",
        [_P] * 6 + [_I] * 7 + [_L] * 3 + [_I] * 3 + [_F, _P]),
    "paged_decode_sm90_smem": ("paged_decode_attention", [_I] * 7),
    "paged_decode_twin_blocks_per_sm": ("paged_decode_attention", [_I] * 6),
    "paged_decode_int8_twin_blocks_per_sm": ("paged_decode_attention_int8",
                                             [_I] * 6),
    "paged_decode_attention_int8_f32": (
        "paged_decode_attention_int8",
        [_P] * 11 + [_I] * 7 + [_L] * 6 + [_I, _F, _P]),
    "paged_decode_attention_int8_bf16": (
        "paged_decode_attention_int8",
        [_P] * 8 + [_I] * 7 + [_L] * 6 + [_I] * 3 + [_F, _P]),
    "decode_attention_f32": (
        "decode_attention", [_P] * 8 + [_I] * 6 + [_L] * 3 + [_I, _F, _P]),
    "decode_attention_bf16": (
        "decode_attention", [_P] * 5 + [_I] * 6 + [_L] * 3 + [_I, _F, _P]),
    "rglru_scan_f32": ("rglru_scan", [_P] * 5 + [_I] * 4 + [_P]),
    "int8_matmul_f32": ("int8_matmul", [_P] * 5 + [_I] * 6 + [_P]),
    "int8_matmul_bf16": ("int8_matmul", [_P] * 5 + [_I] * 6 + [_P]),
    "int8_matmul_decode_bf16": ("int8_matmul", [_P] * 4 + [_I] * 6 + [_P]),
    "sample_tokens_f32": ("sampling", [_P] * 8 + [_I] * 4 + [_P]),
    "sample_tokens_static_smem": ("sampling", [_I]),
    "sample_tokens_max_clusters": ("sampling", [_I] * 3),
    "topk_sample_f32": ("sampling", [_P] * 5 + [_I] * 3 + [_P]),
    "ssd_step_f32": ("ssd_step", [_P] * 10 + [_L] * 4 + [_I] * 7 + [_P]),
    "ssd_step_bf16": ("ssd_step", [_P] * 10 + [_L] * 4 + [_I] * 7 + [_P]),
    "moe_grouped_bf16": ("moe_grouped",
                         [_P, _P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P]),
}


#: Launches of each kernel since the last ``reset_launches()``: a wrapper
#: adds one where it launches its kernel on the card, and nowhere else.
#: A wrapper called inside a CUDA graph capture launches nothing: the
#: engine's step cache (``serving/graphs.py``) takes those counts back out
#: and adds them again at every replay of the graph, so on the served path
#: the counts come from eager calls and from replays.
LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            "paged_decode_attention": 0,
                            "paged_decode_attention_int8": 0,
                            "decode_attention": 0,
                            "int8_matmul": 0, "int8_matmul_prefill": 0,
                            "rglru_scan": 0,
                            "sample_tokens": 0, "topk_sample": 0,
                            "ssd_step": 0, "moe_grouped": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: devices whose tensors take a kernel's plain version: the CPU, and the
#: meta device, whose tensors carry shapes only (the dry run counts the
#: plain path's work on them); a CUDA tensor launches the kernel
PLAIN_DEVICES = ("cpu", "meta")


def refuse_grad(name: str, *tensors):
    """Raise when grad mode is on and an input requires grad: a kernel
    with no backward would return a result cut from the graph (only
    prefill attention and the RG-LRU scan carry an autograd
    ``Function``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it "
                           f"under torch.no_grad() or on inputs that do "
                           f"not require grad")


class KernelLibrary:
    """The loaded entry points, callable by name; each call raises when
    the launch returned a CUDA error."""

    def __init__(self, libs: Dict[str, ctypes.CDLL], build_s: float):
        self.build_s = build_s
        self._fns = {}
        for name, (lib, argtypes) in SIGNATURES.items():
            fn = getattr(libs[lib], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[name] = fn
        self._libs = libs  # keep the handles alive

    def call(self, name: str, *args):
        err = self._fns[name](*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                               f"cudaError {err}")

    def value(self, name: str, *args) -> int:
        """The int a host-side entry (no launch) returns."""
        return self._fns[name](*args)


_LIB: Optional[KernelLibrary] = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc" if cand else None
        if p is not None and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source (in parallel) unless its library is already
    built for this source hash; returns {source name: .so path}."""
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths, procs = {}, {}
    for name in SOURCES:
        so = out_dir / f"lib{name}.so"
        paths[name] = so
        if so.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n"
                          f"{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name}.cu:\n{log}", flush=True)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("building the port's CUDA kernels failed:\n"
                           + "\n".join(failed))
    return paths


def load(verbose: bool = False) -> KernelLibrary:
    """Build (first use) and load every kernel library."""
    global _LIB
    if _LIB is None:
        t0 = time.perf_counter()
        paths = build(verbose=verbose)
        libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
        _LIB = KernelLibrary(libs, time.perf_counter() - t0)
    return _LIB

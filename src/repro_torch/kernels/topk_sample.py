"""The decode sampling tail: wrappers of the hand-written Hopper kernel
``csrc/sampling.cu`` (the port of TPU kernel 3,
``repro/kernels/topk_sample.py::topk_sample``) beside their plain
versions in ``plain``.

``sample_tokens`` is what the engine calls (the semantics of
``plain.sample_tokens``: greedy mask, temperature, top-k, top-p, one
uniform per row, inverse CDF); ``topk_sample`` keeps the Pallas kernel's
own semantics (Gumbel argmax over (B, V) uniforms). A cluster of blocks per
row (``sample_plan``: 8, or 16 where 8 blocks cannot keep the softmax
weights beside the logits, as at vocab 256000, and at most 8 rows share
the card) keeps the whole row in their shared memories, with its weights
beside it where both fit, so the vocabulary must fit in the cluster's
shared memory (``max_vocab``). A stochastic row takes one of three paths
inside the kernel: at most ``CAP`` kept values (a top-k row, or V <= CAP)
go to one block for the nucleus and the draw; otherwise the nucleus is
found by a mass radix over the whole row (top_p < 1) or skipped.
``path_rows()`` counts the rows each path served on each card. A CPU
tensor goes to the plain version; a CUDA tensor launches the kernel or
raises."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
STATIC_SMEM = 16384  # bound on the kernels' own shared memory (``Shared``)
THREADS = 512  # threads of a block
CAP = 512  # kept values the one-block nucleus takes (one a thread)
SPREAD_ROWS = 8  # up to this many rows may take clusters of 16 (128 SMs)
PATHS = ("greedy", "candidates", "mass_radix", "whole_row")

_PATH_ROWS: Dict[torch.device, torch.Tensor] = {}


@dataclass(frozen=True)
class SamplePlan:
    cluster: int  # blocks per row
    chunk: int  # logits a block holds, a multiple of 4 (16-byte slices)
    store_w: bool  # the slice's weights kept beside it

    @property
    def smem(self) -> int:
        """Shared memory of one block: the slice (and its weights), and
        the static part's bound."""
        return 4 * self.chunk * (2 if self.store_w else 1) + STATIC_SMEM


def _chunk(v: int, cluster: int) -> int:
    per = -(-v // cluster)
    return -(-per // 4) * 4


def max_vocab(cluster: int = 16) -> int:
    """The largest vocabulary a cluster of this size holds (16 is the
    largest the kernel takes)."""
    return cluster * ((SMEM_LIMIT - STATIC_SMEM) // 16 * 4)


def _slices(v: int, cluster: int, store_w=None) -> SamplePlan:
    """Block r of a row's cluster holds logits [r * chunk, (r + 1) *
    chunk), and their weights where ``store_w`` (by default, where slice
    and weights fit)."""
    chunk = _chunk(v, cluster)
    if store_w is None:
        store_w = 8 * chunk + STATIC_SMEM <= SMEM_LIMIT
    return SamplePlan(cluster, chunk, bool(store_w))


def sample_plan(b: int, v: int) -> SamplePlan:
    """8 blocks a row, keeping the weights where they fit (granite's
    49152); 16 (a non-portable size on the H100) where 8 blocks cannot
    keep them and at most ``SPREAD_ROWS`` rows share the card
    (recurrentgemma's 256000 at 8 slots: 16 blocks keep them, and 8 rows
    busy 128 SMs), or where 8 blocks cannot hold the row at all."""
    eight = _slices(v, 8)
    if (b <= SPREAD_ROWS and not eight.store_w) or eight.smem > SMEM_LIMIT:
        return _slices(v, 16)
    return eight


def path_rows() -> Dict[str, int]:
    """Rows each path of ``sample_tokens`` served since the last
    ``reset_path_rows()``, summed over the cards (reads them: a
    synchronisation)."""
    total = dict.fromkeys(PATHS, 0)
    for counts in _PATH_ROWS.values():
        for name, n in zip(PATHS, counts.tolist()):
            total[name] += n
    return total


def reset_path_rows():
    for counts in _PATH_ROWS.values():
        counts.zero_()


def _path_counter(device) -> torch.Tensor:
    """The card's row counts by path, made by the first launch there. A
    CUDA graph must not be the first: a tensor made inside a capture is
    never zeroed, so the step is run eagerly once before it is captured
    (``serving/graphs.py``), and a capture that comes first raises."""
    if device not in _PATH_ROWS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "sample_tokens: first launch on this card inside a CUDA "
                "graph capture; run the step eagerly once before capturing "
                "it")
        _PATH_ROWS[device] = torch.zeros(len(PATHS), dtype=torch.int32,
                                         device=device)
    return _PATH_ROWS[device]


def _check_rows(name, logits, *rows):
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (B, V), got "
                         f"{tuple(logits.shape)}")
    b = logits.shape[0]
    for r in rows:
        if r.shape[0] != b or r.device != logits.device:
            raise ValueError(f"{name}: per-row input of shape "
                             f"{tuple(r.shape)} on {r.device} does not "
                             f"match logits {tuple(logits.shape)} on "
                             f"{logits.device}")


def _check_cuda(name, logits, typed, plan):
    if logits.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {logits.device}")
    build.refuse_grad(name, *(t for t, _ in typed))
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"{name}: a vocabulary of {logits.shape[1]} does "
                         f"not fit in {plan.cluster} blocks' shared memory "
                         f"(at most {max_vocab(plan.cluster)} float32 "
                         f"logits)")
    for t, dt in typed:
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt}, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")
    return plan


def sample_tokens(logits, greedy, temperature, top_k, top_p, uniform,
                  _plan=None):
    """logits (B, V) float32; greedy (B,) bool; temperature, top_p,
    uniform (B,) float32; top_k (B,) int32. Returns (B,) int32. ``_plan``
    (tests only): a ``SamplePlan`` to run instead of
    ``sample_plan``'s."""
    _check_rows("sample_tokens", logits, greedy, temperature, top_k, top_p,
                uniform)
    if logits.device.type in build.PLAIN_DEVICES:
        return plain.sample_tokens(logits, greedy, temperature, top_k, top_p,
                                   uniform)
    b, v = logits.shape
    plan = _plan or sample_plan(b, v)
    _check_cuda("sample_tokens", logits,
                [(logits, torch.float32), (greedy, torch.bool),
                 (temperature, torch.float32), (top_k, torch.int32),
                 (top_p, torch.float32), (uniform, torch.float32)], plan)
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    lib = build.load()
    lib.call("sample_tokens_f32", logits.data_ptr(), greedy.data_ptr(),
             temperature.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
             uniform.data_ptr(), out.data_ptr(),
             _path_counter(logits.device).data_ptr(), b, v, plan.cluster,
             int(plan.store_w),
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.LAUNCHES["sample_tokens"] += 1
    return out


def topk_sample(logits, k, temperature, uniform, _cluster=None):
    """logits (B, V) float32; k (B,) int32 in [1, V]; temperature (B,) > 0;
    uniform (B, V) in [0, 1). Returns (B,) int32. ``_cluster`` (tests
    only): 8 or 16 blocks a row instead of ``sample_plan``'s."""
    _check_rows("topk_sample", logits, k, temperature, uniform)
    if logits.device.type in build.PLAIN_DEVICES:
        return plain.topk_sample(logits, k, temperature, uniform)
    b, v = logits.shape
    plan = _slices(v, _cluster or sample_plan(b, v).cluster,
                   store_w=False)
    _check_cuda("topk_sample", logits,
                [(logits, torch.float32), (k, torch.int32),
                 (temperature, torch.float32), (uniform, torch.float32)],
                plan)
    if uniform.shape != logits.shape:
        raise ValueError("topk_sample: uniform must be (B, V)")
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    lib = build.load()
    lib.call("topk_sample_f32", logits.data_ptr(), k.data_ptr(),
             temperature.data_ptr(), uniform.data_ptr(), out.data_ptr(), b, v,
             plan.cluster, torch.cuda.current_stream(logits.device)
             .cuda_stream)
    build.LAUNCHES["topk_sample"] += 1
    return out

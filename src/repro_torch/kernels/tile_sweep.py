"""Times, on the card, the launch choices that the RG-LRU scan and the
sampler do not take, beside the ones they do, each checked against its
plain version.

* The scan: ``csrc/rglru_scan.cu`` built once for each tile (warps a
  block 1, 2, 4, 8; steps a time tile 16, 32; ring stages 4, 8, by
  ``-DSCAN_WARPS``, ``-DSCAN_TT``, ``-DSCAN_STAGES``; the library the
  package loads has 4, 32, 8) at (1, 2560, 4096) and (2, 384, 4096).
* The sampler: clusters of 8 and 16 blocks a row, the softmax weights
  kept beside the logits or recomputed, at vocab 49152 and 256000, under
  phase 2's mix of ``chip_smoke.py``, the bursts' mix (4 greedy rows, 4
  at T 0.8, top-k 50, top-p 0.95), 8 rows of top-k 50, 8 rows of top-p
  0.95 alone and 8 greedy rows; and how many clusters of each the card
  runs at once.

Run from the repository's root on a machine with one GPU:
``PYTHONPATH=src python -m repro_torch.kernels.tile_sweep``. Exits 1
where a choice disagrees with its plain version.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import build, plain
from repro_torch.kernels import topk_sample as ts
from repro_torch.serving import prng

SCAN_SHAPES = ((1, 2560, 4096), (2, 384, 4096))
SCAN_TILES = [(w, tt, st) for w in (1, 2, 4, 8) for tt in (16, 32)
              for st in (4, 8)]


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device ms of one ``fn(i)``: ``iters`` calls captured in one CUDA
    graph, the median of 5 replays (as ``chip_smoke.time_ms``)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def scan_libraries():
    """{(warps, tt, stages): the scan's entry point built for that tile},
    every ``nvcc`` started at once."""
    out = build.BUILD_ROOT / "sweep" / build.source_hash()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for w, tt, st in SCAN_TILES:
        so = out / f"librglru_scan_{w}_{tt}_{st}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DSCAN_WARPS={w}",
               f"-DSCAN_TT={tt}", f"-DSCAN_STAGES={st}", "-o", str(so),
               str(build.CSRC / "rglru_scan.cu")]
        procs[(w, tt, st)] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for tile, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc rglru_scan.cu for {tile}:\n{log}")
        fn = ctypes.CDLL(str(so)).rglru_scan_f32
        fn.argtypes = build.SIGNATURES["rglru_scan_f32"][1]
        fn.restype = ctypes.c_int
        fns[tile] = fn
    return fns


def scan_sweep(gen) -> bool:
    ok = True
    fns = scan_libraries()
    for b, s, l in SCAN_SHAPES:
        sets = [(torch.rand((b, s, l), generator=gen, device="cuda") * 0.2
                 + 0.79,
                 torch.randn((b, s, l), generator=gen, device="cuda"),
                 torch.randn((b, l), generator=gen, device="cuda"))
                for _ in range(2)]
        want = plain.rglru_scan(*sets[0])
        y = torch.empty_like(sets[0][0])
        h = torch.empty_like(sets[0][2])
        for tile, fn in fns.items():
            def run(i, fn=fn):
                # the stream of the moment: the graph's while it captures
                a, x, h0 = sets[i % 2]
                err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                         y.data_ptr(), h.data_ptr(), b, s, l, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"rglru_scan {tile}: cudaError {err}")
            run(0)
            same = torch.equal(y, want[0]) and torch.equal(h, want[1])
            ok &= same
            print(f"rglru_scan B={b} S={s} L={l} warps={tile[0]} "
                  f"tt={tile[1]} stages={tile[2]}: bit-identical {same} "
                  f"ms={time_ms(run):.4f}", flush=True)
    return ok


def sampler_mixes(b):
    stoch = torch.zeros(b, dtype=torch.bool, device="cuda")
    full = lambda v, dt=torch.float32: torch.full(  # noqa: E731
        (b,), v, dtype=dt, device="cuda")
    return {
        "phase 2": (torch.tensor([1, 0, 0, 1, 0, 0, 0, 1], dtype=torch.bool,
                                 device="cuda"),
                    torch.tensor([1.0, 0.7, 1.3, 1.0, 0.9, 1.0, 0.5, 1.0],
                                 device="cuda"),
                    torch.tensor([0, 50, 0, 0, 200, 0, 1, 0],
                                 dtype=torch.int32, device="cuda"),
                    torch.tensor([1.0, 1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 1.0],
                                 device="cuda")),
        "burst": (torch.arange(b, device="cuda") < b // 2, full(0.8),
                  full(50, torch.int32), full(0.95)),
        "8 rows top-k 50": (stoch, full(0.8), full(50, torch.int32),
                            full(0.95)),
        "8 rows top-p 0.95": (stoch, full(0.8), full(0, torch.int32),
                              full(0.95)),
        "8 greedy rows": (~stoch, full(1.0), full(0, torch.int32),
                          full(1.0)),
    }


def sampler_sweep(gen) -> bool:
    ok, b = True, 8
    lib = build.load()
    for v in (49152, 256000):
        logits = torch.randn((b, v), generator=gen, device="cuda") * 4.0
        keys = torch.tensor([prng.prng_key(3000 + i) for i in range(b)],
                            dtype=torch.int64, device="cuda")
        u = prng.uniform(prng.fold_in(keys, torch.full(
            (b,), 7, dtype=torch.int64, device="cuda")), True)
        plans = [ts._slices(v, c, w) for c in (8, 16) for w in (False, True)]
        plans = [p for p in plans if p.smem <= ts.SMEM_LIMIT]
        chosen = ts.sample_plan(b, v)
        for p in plans:
            n = lib.value("sample_tokens_max_clusters", v, p.cluster,
                          int(p.store_w))
            print(f"sampler V={v} cluster {p.cluster} weights kept "
                  f"{p.store_w}{' (sample_plan)' if p == chosen else ''}: "
                  f"clusters on the card at once {n}", flush=True)
        for name, (greedy, temp, top_k, top_p) in sampler_mixes(b).items():
            want = plain.sample_tokens(logits, greedy, temp, top_k, top_p, u)
            line = []
            for p in plans:
                same = torch.equal(ts.sample_tokens(
                    logits, greedy, temp, top_k, top_p, u, _plan=p), want)
                ok &= same
                ms = time_ms(lambda i: ts.sample_tokens(
                    logits, greedy, temp, top_k, top_p, u, _plan=p))
                line.append(f"cluster {p.cluster} weights kept {p.store_w}"
                            f": {ms:.4f}" + ("" if same else " MISMATCH"))
            print(f"sampler V={v} {name} (ms): " + "; ".join(line),
                  flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = scan_sweep(gen)
    ok &= sampler_sweep(gen)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

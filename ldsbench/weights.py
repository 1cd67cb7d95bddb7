"""Seeded weights made on the device in a few large calls.

A family lists its leaves as (path, shape, init); leaves that share an
init are carved out of one flat buffer, filled by ``normal_`` (or
``uniform_``) in blocks of at most ``BLOCK`` elements from one
``torch.Generator`` on the device, and handed out as contiguous views.
The program and the reference read the same tensors; neither makes them.
"""
from __future__ import annotations

import math

import torch

BLOCK = 1 << 28


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def carve(entries, gen, device, dtype):
    """entries: [(path tuple, shape, (kind, a, b))] with kind "normal"
    (mean a, std b), "uniform" (low a, high b) or "const" (value a).
    Returns {path: tensor}; one buffer and a few fills per distinct
    init, in the order the entries first name it."""
    groups = {}
    for path, shape, init in entries:
        groups.setdefault(init, []).append((path, shape))
    out = {}
    for init, items in groups.items():
        total = sum(math.prod(s) for _, s in items)
        buf = torch.empty((total,), dtype=dtype, device=device)
        kind, a, b = init
        for lo in range(0, total, BLOCK):
            part = buf[lo:lo + BLOCK]
            if kind == "normal":
                part.normal_(a, b, generator=gen)
            elif kind == "uniform":
                part.uniform_(a, b, generator=gen)
            else:
                part.fill_(a)
        off = 0
        for path, shape in items:
            n = math.prod(shape)
            out[path] = buf[off:off + n].view(shape)
            off += n
    return out


def nest(flat: dict) -> dict:
    """{("layers", 3, "attn", "wq"): t} -> the program's nested params:
    a dict, whose "layers" is a list of per-layer dicts."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    if "layers" in root:
        root["layers"] = [root["layers"][i]
                          for i in sorted(root["layers"])]
    return root

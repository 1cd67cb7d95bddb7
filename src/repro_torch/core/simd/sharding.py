"""SIMD model-parallel sharding rules of the port (survey §4: "efficient
model sharding" is the crux of distributed inference), the twin of the
JAX package's ``repro/core/simd/sharding.py``.

Every param, optimizer, cache or batch leaf maps to a ``Spec``: one entry
per dimension, an axis name (or a tuple of them) that splits that
dimension in equal blocks over the mesh axis, or None for a dimension kept
whole. The axes:

  * ``model`` - tensor-parallel axis: FFN hidden, attention projections,
    vocab, expert hidden (or the expert axis under expert parallelism).
  * ``data`` - batch for activations; FSDP-style second weight axis for
    models too large for 1-D sharding (grok-1, llama4: params/16 > HBM).
  * ``pod`` - outer data-parallel axis (multi-pod); params replicated
    across pods.

Dims are split only when the axis size divides them; otherwise they stay
whole (replicated), as the reference's rules fall back.

The port's parameter tree holds one dict per layer (``params["layers"]``)
where the reference stacks scanned bodies (``"body"``) behind a leading
layer axis, so every rule here is per layer: no spec carries a layer
dimension. ``make_policy``'s FSDP threshold reads the memory of the
``chip`` it is given (the H100 by default; the reference reads its TPU's).
A mesh is anything with ``axis_names`` and a ``devices`` array whose shape
gives the axis sizes (``repro_torch.launch.mesh.Mesh``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.hardware import H100_SXM, Chip
from repro_torch.tree import flatten, tree_map, unflatten


class Spec(tuple):
    """How one leaf is split: ``Spec(None, "model")`` keeps dim 0 whole and
    splits dim 1 over the ``model`` axis. A tuple, so it compares equal
    to the entries of the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingPolicy:
    model_axis: str = "model"
    data_axis: str = "data"
    batch_axes: Tuple[str, ...] = ("data",)  # ("pod", "data") multi-pod
    fsdp: bool = False  # 2-D weight sharding (data x model)
    expert_parallel: bool = False
    model_size: int = 16
    data_size: int = 16
    # "hd" | "seq" (length-parallel decoding) | "kv_head" (serving: pool
    # pages split over kv heads, so each shard's attention is the
    # single-card attention of its heads)
    kv_shard: str = "hd"
    # Bit-exact profile (sharded serving): split ONLY leaves whose
    # per-shard math is a block of the single-card result - output-dim
    # (_COL) projections, the vocab axis of embed / lm_head, KV on the
    # kv-head axis, and (under expert_parallel) the expert axis of MoE
    # weights. Contraction-dim (_ROW) weights stay whole, so shards
    # exchange activations by concatenation and never add partial
    # products.
    exact: bool = False


def _axes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_policy(cfg, mesh, *, fsdp: Optional[bool] = None,
                chip: Chip = H100_SXM) -> ShardingPolicy:
    axes = _axes(mesh)
    model_n = axes.get("model", 1)
    data_n = axes.get("data", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    if fsdp is None:
        wb = 2 if cfg.dtype == "bfloat16" else 4
        per_dev = cfg.param_count() * wb / max(model_n, 1)
        fsdp = per_dev > 0.5 * chip.hbm_bytes
    return ShardingPolicy(
        batch_axes=batch_axes,
        fsdp=fsdp,
        expert_parallel=cfg.moe_expert_parallel,
        model_size=model_n,
        data_size=data_n,
    )


def serving_policy(cfg, mesh) -> ShardingPolicy:
    """Policy of a sharded ``ServingEngine`` replica: the bit-exact profile
    (``ShardingPolicy.exact``) with paged KV pools split over the kv-head
    axis. Page tables and allocator bookkeeping stay whole and host-side,
    so the paging, prefix and preemption stack is topology-blind."""
    return dataclasses.replace(make_policy(cfg, mesh, fsdp=False),
                               exact=True, kv_shard="kv_head")


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# weight-name classes
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_gate_branch",
        "w_lin_branch", "w_a", "w_x", "lm_head"}  # (in, OUT) -> model on -1
_ROW = {"wo", "w_down", "out_proj", "w_out"}  # (IN, out) -> model on -2
_VEC_MODEL = {"Lambda", "b_a", "b_x", "norm_scale"}  # split feature vecs


def _param_spec(name: str, core: Tuple[int, ...], pol: ShardingPolicy):
    """One per-layer (or top-level) weight's spec."""
    m, d = pol.model_size, pol.data_size

    def out(*spec):
        return Spec(*(spec + (None,) * (len(core) - len(spec))))

    if pol.exact:
        # bit-exact profile: no contraction-dim split anywhere. _COL
        # outputs and the embed / lm_head vocab axis split (per-shard
        # products keep the whole contraction); MoE expert weights split
        # the expert axis under expert_parallel. Everything else whole.
        if name == "embed":
            return out("model" if _div(core[0], m) else None, None)
        if name in _COL or name in _ROW:
            if len(core) == 3:  # MoE expert weights (E, d, ff)/(E, ff, d)
                if pol.expert_parallel and _div(core[0], m):
                    return out("model", None, None)
                if name in _COL and _div(core[2], m):
                    return out(None, None, "model")  # ff is an output dim
                return out(None, None, None)  # w_down: ff is contracted
            if len(core) == 2 and name in _COL and _div(core[1], m):
                return out(None, "model")
        return out()

    if name == "embed":
        v, dm = core
        sv = "model" if _div(v, m) else None
        sd = "data" if (pol.fsdp and _div(dm, d)) else None
        return out(sv, sd)
    if name == "router":
        return out(None, None)
    if name == "conv_w":
        return out(None, "model" if _div(core[-1], m) else None)
    if name in _VEC_MODEL and len(core) == 1:
        return out("model" if _div(core[0], m) else None)
    if name in ("A_log", "D", "dt_bias", "scale", "bias"):
        return out()
    if name in _COL or name in _ROW:
        if len(core) == 3:  # MoE expert weights (E, d, ff) / (E, ff, d)
            if pol.expert_parallel and _div(core[0], m):
                sd = "data" if (pol.fsdp and _div(core[1], d)) else None
                return out("model", sd, None)
            # ff-split experts (+ FSDP second axis on d)
            ff_ax = 2 if name in _COL else 1
            d_ax = 1 if name in _COL else 2
            spec3 = [None, None, None]
            if _div(core[ff_ax], m):
                spec3[ff_ax] = "model"
            if pol.fsdp and _div(core[d_ax], d):
                spec3[d_ax] = "data"
            return out(*spec3)
        if len(core) == 2:
            o_ax = 1 if name in _COL else 0
            i_ax = 1 - o_ax
            spec2 = [None, None]
            if _div(core[o_ax], m):
                spec2[o_ax] = "model"
            if pol.fsdp and _div(core[i_ax], d):
                spec2[i_ax] = "data"
            return out(*spec2)
    return out()


def _map_named(fn, tree):
    """``fn(names, leaf)`` over ``tree``'s leaves, names the leaf's path
    split at "/" ("layers", "0", "attn", "wq")."""
    return unflatten(tree, [fn(tuple(path.split("/")), leaf)
                            for path, leaf in flatten(tree)])


def param_pspecs(cfg, param_tree, pol: ShardingPolicy):
    """Spec tree matching ``param_tree`` (tensors, meta tensors included)."""
    return _map_named(lambda names, leaf: _param_spec(
        names[-1], tuple(leaf.shape), pol), param_tree)


def opt_pspecs(cfg, opt_tree, pol: ShardingPolicy):
    """Optimizer state: ZeRO-style, forced 2-D (fsdp) so the float32
    master, m and v never exceed one device's memory."""
    pol2 = dataclasses.replace(pol, fsdp=True)

    def spec_for(names, leaf):
        if len(leaf.shape) == 0:  # step counter
            return Spec()
        return _param_spec(names[-1], tuple(leaf.shape), pol2)

    return _map_named(spec_for, opt_tree)


def _batch_dim_spec(b: int, pol: ShardingPolicy, mesh_axes: dict):
    n = 1
    for a in pol.batch_axes:
        n *= mesh_axes.get(a, 1)
    if _div(b, n):
        return pol.batch_axes if len(pol.batch_axes) > 1 else pol.batch_axes[0]
    if _div(b, mesh_axes.get("data", 1)):
        return "data"
    return None


def batch_pspecs(cfg, batch_tree, pol: ShardingPolicy, mesh):
    axes = _axes(mesh)

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        if names[-1] == "positions":  # (3, B, S)
            bs = _batch_dim_spec(shape[1], pol, axes)
            return Spec(None, bs, *([None] * (len(shape) - 2)))
        if names[-1] == "pos":
            return Spec(*([None] * len(shape)))
        bs = _batch_dim_spec(shape[0], pol, axes)
        return Spec(bs, *([None] * (len(shape) - 1)))

    return _map_named(spec_for, batch_tree)


def cache_pspecs(cfg, cache_tree, pol: ShardingPolicy, mesh):
    """Rolling caches: batch dim -> batch axes; the K/V kv-head dim under
    the serving profile, else head_dim (or the sequence under "seq"), and
    recurrent states' feature dims -> model."""
    axes = _axes(mesh)
    m = pol.model_size

    def spec_for(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        if name == "pos":
            return Spec(*([None] * len(shape)))
        spec = [_batch_dim_spec(shape[0], pol, axes)] + [None] * (
            len(shape) - 1)
        if name in ("k", "v"):
            # (B, W, kv, hd)
            if pol.kv_shard == "kv_head" and _div(shape[2], m):
                spec[2] = "model"
            elif pol.kv_shard == "seq" and _div(shape[1], m):
                spec[1] = "model"
            elif pol.kv_shard == "hd" and _div(shape[3], m):
                spec[3] = "model"
        elif name in ("k_scale", "v_scale"):
            # (B, W, kv, 1): the int8 cache's per-vector scales follow the
            # values' W / kv layout (the trailing singleton stays whole)
            if pol.kv_shard == "seq" and _div(shape[1], m):
                spec[1] = "model"
            elif pol.kv_shard == "kv_head" and _div(shape[2], m):
                spec[2] = "model"
        elif pol.exact:
            pass  # recurrent state / conv: whole (a split scan would add)
        elif name == "conv":
            if _div(shape[-1], m):
                spec[-1] = "model"
        elif name == "state":
            if len(shape) == 4 and _div(shape[1], m):  # ssd (B, H, P, N)
                spec[1] = "model"
            elif len(shape) == 2 and _div(shape[1], m):  # rglru (B, L)
                spec[1] = "model"
        return Spec(*spec)

    return _map_named(spec_for, cache_tree)


def paged_cache_pspecs(cfg, cache_tree, pol: ShardingPolicy, mesh):
    """Paged-KV layout: the shared pools (P, page_size, kv, hd) split the
    kv-head dim over ``model`` (falling back to hd, then to whole, on
    divisibility); the page table and the slots' positions stay whole, so
    the host-side ``PageAllocator`` / ``PrefixIndex`` see the single-card
    layout. Pool pages are never split by batch: page ids are global,
    and any slot's table row must reach any page."""
    m = pol.model_size

    def spec_for(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if name in ("k", "v") and len(shape) == 4:
            if pol.kv_shard != "hd" and _div(shape[2], m):
                spec[2] = "model"
            elif _div(shape[3], m):
                spec[3] = "model"
        elif name in ("k_scale", "v_scale") and len(shape) == 4:
            # (P, ps, kv, 1): int8 pools' scale pages split the kv-head
            # dim with the values; under an hd-split value layout the
            # (hd-less) scales stay whole
            if pol.kv_shard != "hd" and _div(shape[2], m):
                spec[2] = "model"
        return Spec(*spec)

    return _map_named(spec_for, cache_tree)


# ---------------------------------------------------------------------------
# placement: one tree per shard
# ---------------------------------------------------------------------------


class Shards(list):
    """One tree per shard of ``mesh``: shard j's leaves on
    ``mesh.flat[j]`` (a sharded replica's params or caches)."""

    def __init__(self, trees, mesh):
        super().__init__(trees)
        self.mesh = mesh


def _block_coords(spec, mesh, j: int) -> list:
    """Shard j's (coordinate, block count) along each dimension of
    ``spec`` that splits: (0, 1) for a dimension kept whole."""
    coords, sizes = mesh.coords(j), mesh.shape
    out = []
    for entry in spec:
        n, c = 1, 0
        if entry is not None:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n, c = n * sizes[a], c * sizes[a] + coords[a]
        out.append((c, n))
    return out


def shard_block(t, spec, mesh, j: int):
    """Shard j's block of ``t`` under ``spec``: every split dimension
    narrowed to the block at shard j's coordinate along its axis (a view
    of ``t``)."""
    for dim, (c, n) in enumerate(_block_coords(spec, mesh, j)):
        if n > 1:
            w = t.shape[dim] // n
            t = t.narrow(dim, c * w, w)
    return t


def place(tree, spec_tree, mesh, *, shared=None) -> list:
    """One tree per shard: shard j's block (``shard_block``) of every leaf
    on ``mesh.flat[j]``. A leaf already on a shard's device gives that
    shard a view of its block (shards stacked on one device share the
    leaf's memory: a whole leaf is not copied, a column block is read in
    place with the whole leaf's row stride); a leaf elsewhere is copied to
    the shard's device, its block only, contiguous; a leaf on the meta
    device becomes zeros of the block's shape. ``shared``, a predicate on
    a leaf's path ("layers/0/k"), marks leaves whose shards on one device
    that hold the same block get one tensor between them (a replica's
    page pools, which its data rows hold whole and must all see every
    write to)."""
    paths = [path for path, _ in flatten(tree)]
    memo = {}
    shards = []
    for j, dev in enumerate(mesh.flat):
        at = iter(paths)

        def one(leaf, spec, j=j, dev=dev):
            path = next(at)
            key = None
            if shared is not None and shared(path):
                key = (path, str(dev), tuple(_block_coords(spec, mesh, j)))
                if key in memo:
                    return memo[key]
            blk = shard_block(leaf, spec, mesh, j)
            if leaf.device.type == "meta":
                blk = torch.zeros(blk.shape, dtype=blk.dtype, device=dev)
            elif blk.device != dev:
                blk = torch.empty(blk.shape, dtype=blk.dtype,
                                  device=dev).copy_(blk)
            if key is not None:
                memo[key] = blk
            return blk
        shards.append(tree_map(one, tree, spec_tree))
    return shards

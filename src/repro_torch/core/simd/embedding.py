"""DLRM inference on one card (survey §4.3.1, Fig. 7; [26] Lui et al.).

The survey's flagship SIMD workload: embedding tables dominate the weights
(80-95%) with almost no FLOPs. ``dlrm_forward`` is the whole model (bottom
MLP, per-table multi-hot lookups summed, pairwise dot interaction, top
MLP), as the reference's. The lookups are one ``embedding_bag`` (sum) over
the tables viewed as one (T R, E) matrix: a gather, as the reference's
``jnp.take`` is outside any Pallas kernel.

The deployment layout is the reference's (``shard_specs``,
``batch_specs``): tables row-split over the mesh's ``model`` axis, MLPs
whole. ``dlrm_forward`` also takes such a replica (``sharding.place`` of
the params under ``shard_specs``: ``Shards``): each shard pools the ids
that fall in its row block (``sharded_lookup``), and the pooled partial
sums come back to the first shard's device and are added there in shard
order, the RPC fan-out of Fig. 7. That float32 sum adds in another order
than one table's pooled sum: the two agree to a few float32 rounding
steps of the pooled rows' magnitude, not bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.core.simd.sharding import Shards, Spec

F32 = torch.float32


def init_dlrm(cfg, generator=0, device="cuda"):
    """Random float32 weights on ``device``, scaled as the reference's:
    tables N(0, 0.01^2), each MLP weight N(0, 1 / fan_in), zero biases.
    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed of
    a new one. The tables are drawn in place, so the card needs room for
    them once (``cfg.embedding_params()`` floats)."""
    if cfg.bottom_mlp[-1] != cfg.embed_dim:
        raise ValueError("bottom MLP must project dense features to "
                         "embed_dim")
    device = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(
            int(generator))
    tables = torch.randn((cfg.num_tables, cfg.rows_per_table, cfg.embed_dim),
                         generator=generator, dtype=F32, device=device)
    tables.mul_(0.01)

    def mlp(dims):
        return [{"w": torch.randn((a, b), generator=generator, dtype=F32,
                                  device=device) * a ** -0.5,
                 "b": torch.zeros((b,), dtype=F32, device=device)}
                for a, b in zip(dims[:-1], dims[1:])]

    bot_dims = (cfg.num_dense_features,) + cfg.bottom_mlp
    num_int = (cfg.num_tables + 1) * cfg.num_tables // 2
    top_dims = (num_int + cfg.embed_dim,) + cfg.top_mlp
    return {"tables": tables, "bottom": mlp(bot_dims), "top": mlp(top_dims)}


def _mlp_apply(layers, x, final_act=False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def lookup(tables, sparse):
    """Multi-hot lookups: for tables (T, R, E) and row ids sparse (B, T, M),
    each table's M rows summed, (B, T, E)."""
    t, r, e = tables.shape
    b, _, m = sparse.shape
    offsets = torch.arange(t, device=sparse.device, dtype=torch.int64) * r
    ids = (sparse.to(torch.int64) + offsets[:, None]).reshape(b * t, m)
    return F.embedding_bag(ids, tables.reshape(t * r, e),
                           mode="sum").reshape(b, t, e)


def sharded_lookup(tables, sparse):
    """``lookup`` over row-split tables: ``tables`` one (T, R / n, E) block
    per shard (shard j holds rows [j R / n, (j + 1) R / n) of every
    table). Each shard pools, per bag, the ids in its block (the others
    weigh 0); the pooled (B, T, E) partial sums are added on ``sparse``'s
    device in shard order."""
    total = None
    for j, blk in enumerate(tables):
        r = blk.shape[1]
        ids = sparse.to(blk.device, torch.int64) - j * r
        inside = (ids >= 0) & (ids < r)
        ids = torch.clamp(ids, 0, r - 1)
        # table by table: a shard's block may be a strided view of the
        # whole tables (shards on one device), each table's rows are not
        part = torch.stack([F.embedding_bag(
            ids[:, i], blk[i], mode="sum",
            per_sample_weights=inside[:, i].to(blk.dtype))
            for i in range(blk.shape[0])], dim=1).to(sparse.device)
        total = part if total is None else total + part
    return total


def dlrm_forward(cfg, params, batch):
    """batch: ``dense`` (B, 13) float32, ``sparse`` (B, T, multi_hot)
    integer row ids. Returns the CTR logit (B,) float32. ``params`` may be
    a replica's ``Shards`` (``shard_specs``): the MLPs run on the first
    shard's device, where the batch lies, and the lookups over every
    shard's row block (``sharded_lookup``)."""
    dense, sparse = batch["dense"], batch["sparse"]
    if isinstance(params, Shards):
        emb = sharded_lookup([p["tables"] for p in params], sparse)
        params = params[0]
    else:
        emb = lookup(params["tables"], sparse)  # (B, T, E)
    bot = _mlp_apply(params["bottom"], dense, final_act=True)  # (B, E)
    # pairwise dot interaction over [bottom] + T embeddings
    z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, T+1, E)
    inter = torch.bmm(z, z.transpose(1, 2))  # (B, T+1, T+1)
    # the upper triangle in np.triu_indices order, built on the device (a
    # host copy here would wait for the queued work on every call)
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    inter_flat = inter[:, iu, ju]  # (B, T(T+1)/2)
    top_in = torch.cat([bot, inter_flat], dim=-1)
    return _mlp_apply(params["top"], top_in)[:, 0]


def shard_specs(cfg) -> dict:
    """Deployment layout: tables row-split over ``model`` (the scale-out
    dimension of [26]); MLPs whole (they are tiny)."""
    return {
        "tables": Spec(None, "model", None),
        "bottom": [{"w": Spec(None, None), "b": Spec(None)}
                   for _ in range(len(cfg.bottom_mlp))],
        "top": [{"w": Spec(None, None), "b": Spec(None)}
                for _ in range(len(cfg.top_mlp))],
    }


def batch_specs(cfg) -> dict:
    return {"dense": Spec("data", None), "sparse": Spec("data", None, None)}


def lookup_traffic_bytes(cfg, batch: int) -> float:
    """Bytes of embedding rows one query batch gathers (each lookup returns
    one embed_dim float32 row): the 'RPC fan-out' volume of Fig. 7 when
    the tables are sharded, and the row reads of one card otherwise."""
    rows = batch * cfg.num_tables * cfg.multi_hot
    return rows * cfg.embed_dim * 4.0

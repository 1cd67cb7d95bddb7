"""Typed, versioned engine telemetry: the port's copy of the JAX package's
``serving/telemetry.py``, whose wire form it keeps (a report of either
package reads in the other).

``LoadReport`` is the contract between one ``ServingEngine`` replica and
everything that watches it: the cluster router's predicted-completion
simulation, the autoscaler, the health watchdog, the chaos harness, and
the benches' JSON artifacts. It is versioned (``schema_version``) with a
``to_dict``/``from_dict`` wire shape so reports can cross process
boundaries (future cross-engine KV migration) without pickling.

Schema history:
  v1 — implicit shape (slots/pages/backlog/lifecycle counters).
  v2 — explicit ``schema_version``; per-mesh-axis fields (``mesh_axes``,
       ``axis_collective_s``, ``axis_util``) for an n-card sharded
       replica; MoE capacity-policy fields.
  v3 — observability: ``histograms`` (sparse TTFT/TPOT/JCT latency
       histograms in the serving metrics' wire form, exactly mergeable),
       ``span_totals`` (per-span-kind (count, seconds) rollups from
       request traces), ``compile_events`` (compiled steps per key: the
       port's captured graphs, under the reference's key names).
  v4 — overload control: ``browned_out`` and ``tenant_stats`` (per-tenant
       counters and TTFT histograms in ``TenantMetrics.to_wire`` form).
  v5 — quantized serving: ``kv_bytes_per_token`` (the replica's per-token
       KV cost, pool dtype included) and ``kv_cache_dtype`` /
       ``weight_dtype`` (its ``PrecisionConfig`` storage dtypes, "" = the
       model dtype).

Readers upgrade old wire dicts through ``_UPGRADES``: one table-driven
step per historical version (v_n -> v_{n+1}), walked in order — adding a
schema version means appending ONE entry, not threading a new ad-hoc
branch through ``from_dict``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields

SCHEMA_VERSION = 5

#: tuple-of-tuples fields that serialize as lists (JSON has no tuples)
_TUPLE_FIELDS = ("active_remaining", "queued_budgets", "mesh_axes",
                 "axis_collective_s", "axis_util")

#: arbitrarily nested tuple fields (v3+) — converted recursively
_DEEP_FIELDS = ("histograms", "span_totals", "compile_events",
                "tenant_stats")

#: the port's local fields, kept off the wire
_LOCAL_FIELDS = ("state_bytes", "kv_ring_bytes")


def _listify(x):
    if isinstance(x, tuple):
        return [_listify(v) for v in x]
    return x


def _tuplify(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclass(frozen=True)
class LoadReport:
    """One engine's telemetry snapshot — the routing signal the cluster
    frontend consumes. Everything is host-side
    bookkeeping: taking a report never syncs the device."""

    slots: int
    free_slots: int  # slots with no active or prefilling request
    queued_requests: int  # backlog + admission-accumulator pending
    queued_prefill_tokens: int  # prompt tokens not yet through prefill
    decode_tokens_remaining: int  # unfinished token budgets, queued incl.
    free_pages: int  # page pool headroom (-1: rolling cache, unpaged)
    total_pages: int  # usable pool capacity (0 when unpaged)
    backlog_s: float  # cost-model seconds to drain the outstanding work
    tick_est_s: float  # cost-model latency of one batched decode tick
    queued_prefill_s: float  # cost-model seconds for the queued prefills
    # per-slot remaining token budgets of in-flight requests (prefilling
    # slots count their budget plus pending chunk ticks), and the queued
    # requests' budgets in the order the backlog will drain them — the
    # inputs to the cluster's slot-availability simulation
    active_remaining: tuple = ()
    queued_budgets: tuple = ()
    # --- prefix cache (0s when the index is off) ---
    prefix_cached_pages: int = 0  # pages currently held by the index
    prefix_cached_tokens: int = 0
    prefix_hits: int = 0  # cumulative admissions served from the cache
    prefix_hit_tokens: int = 0  # cumulative prompt tokens skipped
    # --- lifecycle / fault tolerance (cumulative ServeMetrics mirrors;
    # the cluster watchdog also reads report freshness as the replica's
    # health signal) ---
    rejected: int = 0
    cancelled: int = 0
    timed_out: int = 0
    shed: int = 0
    failed: int = 0
    preempted: int = 0
    # --- v2: sharded-replica shape (1-chip default) ---
    schema_version: int = SCHEMA_VERSION
    # ((axis, size), ...): the device mesh this replica spans
    mesh_axes: tuple = (("data", 1), ("model", 1))
    # ((axis, seconds), ...): modeled per-axis collective time inside one
    # full-batch decode tick (all-reduce/all-gather on "model", expert
    # all-to-all folded into "model" for TPxEP meshes)
    axis_collective_s: tuple = ()
    # ((axis, fraction), ...): axis_collective_s / tick_est_s — how much of
    # a tick the replica spends moving bytes over each mesh axis; the
    # router's sharding-overhead signal
    axis_util: tuple = ()
    # --- v2: MoE capacity policy (empty/0 for dense archs) ---
    moe_capacity_policy: str = ""
    moe_drop_free_group: int = 0  # largest never-dropping token group
    # --- v3: observability ---
    # ((name, histogram-wire), ...): non-empty ServeMetrics latency
    # histograms (latency_s/jct_s/ttft_s/tpot_s) in the sparse
    # serving.metrics.Histogram.to_wire form — exactly mergeable
    # across replicas, so cluster percentiles need no sample shipping
    histograms: tuple = ()
    # ((span kind, count, seconds), ...): per-kind rollups folded from
    # terminal request traces (empty with tracing off)
    span_totals: tuple = ()
    # ((compiled-step key, count), ...): compiled steps per shape key —
    # the flat-compile-count invariant as queryable telemetry
    compile_events: tuple = ()
    # --- v4: multi-tenant overload control ---
    # cumulative requests this replica served with a brownout-trimmed
    # token budget (mirrors ServeMetrics.browned_out)
    browned_out: int = 0
    # per-tenant counters + TTFT histograms in TenantMetrics.to_wire
    # form: ((tenant, (counters...), ttft-wire-or-()), ...) — exactly
    # mergeable across replicas like everything else on this wire
    tenant_stats: tuple = ()
    # --- v5: serving-path precision (quantized replicas) ---
    # HBM bytes one resident cached token costs on THIS replica (pool
    # dtype included) — the router/cost model's capacity unit for
    # heterogeneous pools; 0.0 from pre-v5 reports means "unknown, assume
    # model dtype"
    kv_bytes_per_token: float = 0.0
    # the replica's PrecisionConfig storage dtypes ("" = model dtype)
    kv_cache_dtype: str = ""
    weight_dtype: str = ""
    # --- port-only, local: the cache's device bytes of recurrent state
    # (SSD and RG-LRU conv windows and states) and of KV rings (rolling
    # caches; a paged pool is not a ring). Not on the wire, which is the
    # reference's, and not compared, so a report equals its round trip ---
    state_bytes: int = field(default=0, compare=False)
    kv_ring_bytes: int = field(default=0, compare=False)

    @property
    def saturated(self) -> bool:
        """No slot free for an immediate admission."""
        return self.free_slots <= 0

    @property
    def n_chips(self) -> int:
        n = 1
        for _, size in self.mesh_axes:
            n *= int(size)
        return n

    # -- wire shape --------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe dict (tuples -> lists), carrying ``schema_version``."""
        d = asdict(self)
        for k in _LOCAL_FIELDS:
            del d[k]
        for k in _TUPLE_FIELDS:
            d[k] = [list(x) if isinstance(x, tuple) else x for x in d[k]]
        for k in _DEEP_FIELDS:
            d[k] = _listify(d[k])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LoadReport":
        """Inverse of ``to_dict``. Historical versions (v1: no version
        field; v2-v4: missing newer fields) upgrade through the
        ``_UPGRADES`` table one step at a time; FUTURE schemas are
        rejected instead of silently mis-read."""
        version = int(d.get("schema_version", 1))
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"LoadReport schema v{version} is newer than this "
                f"reader (v{SCHEMA_VERSION}); upgrade the consumer")
        d = dict(d)
        for v in range(version, SCHEMA_VERSION):
            d = _UPGRADES[v](d)
        known = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        for k in _TUPLE_FIELDS:
            if k in kw:
                kw[k] = tuple(tuple(x) if isinstance(x, list) else x
                              for x in kw[k])
        for k in _DEEP_FIELDS:
            if k in kw:
                kw[k] = _tuplify(kw[k])
        kw["schema_version"] = SCHEMA_VERSION
        return cls(**kw)


# -- table-driven wire upgrades (v_n dict -> v_{n+1} dict) ------------------
# Every historical bump so far only ADDED fields whose dataclass defaults
# are the correct backfill, so each step is the identity on the payload;
# a future bump that renames/reshapes a field writes its migration here
# (and ONLY here) instead of branching inside from_dict.


def _add_fields_step(d: dict) -> dict:
    return d


_UPGRADES = {
    1: _add_fields_step,  # v1 -> v2: + mesh/axis + MoE capacity fields
    2: _add_fields_step,  # v2 -> v3: + histograms/span_totals/compiles
    3: _add_fields_step,  # v3 -> v4: + browned_out/tenant_stats
    4: _add_fields_step,  # v4 -> v5: + kv_bytes_per_token/precision dtypes
}
assert sorted(_UPGRADES) == list(range(1, SCHEMA_VERSION)), (
    "every historical schema version needs exactly one upgrade step")

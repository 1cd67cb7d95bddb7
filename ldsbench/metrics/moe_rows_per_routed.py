"""MoE layer: rows the expert products computed per routed (token,
expert) pair, over the window's delivery periods (the engine's host-side
counters ``moe_expert_rows`` and ``moe_routed_pairs`` on the step
timeline's records, from the steps' shapes; before the profiled
sub-window: ``_timeline``): 1 where each pair is computed once (the
token-sorted prefill), E / k where every expert's buffer is computed
for every token (a full-capacity decode tick). A program without the
counters gives nothing to read."""
from ldsbench.metrics._timeline import periods


def read(run):
    rows = pairs = 0
    for p in periods(run):
        counts = getattr(p, "counts", None) or {}
        rows += counts.get("moe_expert_rows", 0)
        pairs += counts.get("moe_routed_pairs", 0)
    return rows / pairs if pairs else None

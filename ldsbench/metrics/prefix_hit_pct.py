"""Prefix-cache layer: prompt tokens served from the prefix cache, as a
share of the prompt tokens of the requests the window admitted
(``Request.prefix_hit_tokens``; 0 where the cache is off)."""


def read(run):
    adm = [r for r in run.recs if r.first is not None and r.sent >= run.t0]
    total = sum(r.prompt_len for r in adm)
    return 100.0 * sum(r.hit for r in adm) / total if total else None

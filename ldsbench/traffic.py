"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed -> the requests of a run.

A mix fixes its schedule: every size, arrival gap, greedy row and
document choice is drawn from the mix's own ``schedule_seed``, by
stratified quantiles (n requests take the distribution's quantiles at
(i + 0.5) / n, in an order the schedule seed permutes). The run's seed
draws the data: every token id and each seeded row's sampling seed (and
the weights, elsewhere). So every seed sends the same work at the same
times, with other tokens: near a knee the order of a Poisson stream's
bursts alone moved the TTFT tail by half between seeds.

Distributions (``{"dist": ...}``): ``lognormal`` (median, sigma, min,
max), ``uniform`` (min, max, integers), ``const`` (value). Loops:

- ``open``: ``rate_per_s`` x ``seconds`` requests (rounded), their
  exponential gaps scaled to end at ``seconds``: the arrival times of a
  Poisson stream given its count;
- ``closed``: ``clients`` clients, each sending its next request when the
  last one finishes, from a pool of ``pool`` requests taken in order.
  With ``first_output`` "residual", each client's first request keeps a
  uniform share (0, 1] of its drawn output length, so completions start
  spread out as in a loop that has run for a while.

``documents`` (optional): ``count`` documents of ``length`` tokens, made
in set-up; each request's prompt is a document chosen by Zipf (``zipf_s``)
followed by a ``question`` of its own.

``max_context`` (optional): the configuration's published context; a mix
whose prompt and output can pass it is refused.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Planned:
    idx: int
    prompt: np.ndarray  # int32 token ids
    max_new: int
    greedy: bool
    sample_seed: int
    due: float = 0.0  # open loop: seconds after the window opens
    doc: int = -1


@dataclass
class Traffic:
    loop: str
    requests: List[Planned]
    clients: int = 0
    documents: List[np.ndarray] = field(default_factory=list)


def quantile(dist: dict, q: float) -> float:
    kind = dist["dist"]
    if kind == "const":
        return dist["value"]
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return min(hi, lo + math.floor(q * (hi - lo + 1)))
    if kind == "lognormal":
        v = dist["median"] * math.exp(dist["sigma"]
                                      * NormalDist().inv_cdf(q))
        return int(min(dist["max"], max(dist["min"], round(v))))
    raise ValueError(f"unknown distribution {kind!r}")


def stratified(dist: dict, n: int, rng) -> np.ndarray:
    vals = np.array([quantile(dist, (i + 0.5) / n) for i in range(n)])
    return vals[rng.permutation(n)]


def shares(n: int, share: float, rng) -> np.ndarray:
    """n booleans, round(n * share) of them True, in a seeded order."""
    out = np.zeros(n, bool)
    out[:int(round(n * share))] = True
    return out[rng.permutation(n)]


def zipf_choice(n: int, k: int, s: float, rng) -> np.ndarray:
    """n draws over k items with p_i ~ 1 / (i + 1)^s, by stratified
    quantiles of the categorical distribution, in a seeded order."""
    p = np.array([1.0 / (i + 1) ** s for i in range(k)])
    cdf = np.cumsum(p / p.sum())
    q = (np.arange(n) + 0.5) / n
    return np.searchsorted(cdf, q)[rng.permutation(n)]


def count(mix: dict, seconds: float) -> int:
    if mix["loop"] == "open":
        return max(1, int(round(mix["rate_per_s"] * seconds)))
    return int(mix["pool"])


def _rng(*words):
    return np.random.default_rng([int(w) & 0xFFFFFFFF for w in words]
                                 + [int(w) >> 32 for w in words])


def build(mix: dict, vocab: int, seed: int, seconds: float) -> Traffic:
    sched = _rng(mix["schedule_seed"], 17)
    data = _rng(seed, 23)
    n = count(mix, seconds)
    docs = []
    dspec = mix.get("documents")
    if dspec:
        lens = stratified(dspec["length"], dspec["count"], sched)
        docs = [data.integers(0, vocab, int(L), dtype=np.int32)
                for L in lens]
        which = zipf_choice(n, len(docs), dspec["zipf_s"], sched)
        plen = stratified(dspec["question"], n, sched)
    else:
        plen = stratified(mix["prompt"], n, sched)
    outs = stratified(mix["output"], n, sched)
    greedy = shares(n, mix["greedy_share"], sched)
    seeds = data.integers(0, 2 ** 31 - 1, n)
    reqs = []
    for i in range(n):
        prompt = data.integers(0, vocab, int(plen[i]), dtype=np.int32)
        doc = -1
        if docs:
            doc = int(which[i])
            prompt = np.concatenate([docs[doc], prompt])
        reqs.append(Planned(i, prompt, int(outs[i]), bool(greedy[i]),
                            int(seeds[i]), doc=doc))
    cap = mix.get("max_context")
    if cap is not None:
        worst = max(len(r.prompt) + r.max_new for r in reqs)
        if worst > cap:
            raise ValueError(f"the mix reaches {worst} positions, over its "
                             f"max_context of {cap}")
    if mix["loop"] == "open":
        q = (np.arange(n) + 0.5) / n
        gaps = (-np.log1p(-q))[sched.permutation(n)]
        due = (np.cumsum(gaps) - gaps) / gaps.sum() * seconds
        for r, d in zip(reqs, due):
            r.due = float(d)
    elif mix.get("first_output") == "residual":
        u = (np.arange(mix["clients"]) + 0.5) / mix["clients"]
        for r, share in zip(reqs, u[sched.permutation(mix["clients"])]):
            r.max_new = max(1, int(math.ceil(share * r.max_new)))
    return Traffic(mix["loop"], reqs, int(mix.get("clients", 0)), docs)


def check_sample(done: list, spec: dict, seed: int) -> list:
    """The requests the check compares: the one with the most served
    tokens (prompt and output) always, then ``greedy`` greedy and
    ``sampled`` sampled ones drawn from the seed among those with at
    least ``min_tokens`` served tokens."""
    rng = _rng(seed, 29)
    pool = [r for r in done if r.n_out >= spec.get("min_tokens", 2)]
    if not pool:
        return []
    longest = max(pool, key=lambda r: (r.prompt_len + r.n_out, r.idx))
    picked = [longest]
    for greedy, k in ((True, spec["greedy"]), (False, spec["sampled"])):
        cands = [r for r in pool if r.greedy == greedy and r is not longest]
        order = rng.permutation(len(cands))
        picked += [cands[i] for i in order[:k]]
    return picked


"""The benchmark's driver: one cell (a configuration under a traffic mix)
from the seed to its result line.

``run_cell`` builds the weights on the device from the seed (the
family's ``make_weights``, in the program's parameter layout), builds
``repro_torch.serving.ServingEngine`` from the mix's ``engine`` knobs,
warms the shapes this cell's traffic reaches, does the traffic's own
set-up (documents into the prefix cache), then drives ``submit`` /
``step`` for the window on the host clock (``time.perf_counter``, which
is also the ``now`` the engine is given), stamping each request's tokens
when the call that delivered them returns. After the window the engine
is freed and the reference checks a sample of what was served
(``judge``). Everything a configuration, a mix or a metric adds is found
by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``families/<family>.py``, ``reference/<family>.py``,
``metrics/<metric>.py`` and ``limits/<workload>.json``.
"""
from __future__ import annotations

import gc
import importlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ldsbench import profile as prof_mod
from ldsbench import traffic as traffic_mod
from ldsbench.metrics import _common

HERE = Path(__file__).resolve().parent
COUNTERS = ("decode_ticks", "prefill_chunks")
#: the traced run's profiled sub-window: where it starts (share of the
#: window) and how long it lasts at most (seconds)
PROFILE_AT, PROFILE_S = 0.4, 2.0
#: engine methods the traced run labels, so that ``breakdown``'s idle
#: gaps name what the host was doing: the ones the breakdowns have shown
#: to hold idle time. Best effort: a method the engine no longer has is
#: skipped, and its gaps count under the enclosing label (``engine.step``)
LABELLED = ("step", "submit", "_run_prefill_chunks", "_activate",
            "_distribute")


@dataclass
class Rec:
    """One request as the benchmark saw it (host-clock seconds)."""

    idx: int
    prompt: np.ndarray
    greedy: bool
    sent: float
    due: float
    req: object = None
    first: Optional[float] = None
    last: Optional[float] = None
    n_out: int = 0
    n_win: int = 0  # tokens delivered by the window's close
    n_open: int = 0  # tokens delivered before the window opened
    last_win: Optional[float] = None
    failed: bool = False
    queue_end: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def hit(self) -> int:
        return int(getattr(self.req, "prefix_hit_tokens", 0) or 0)


@dataclass
class Run:
    """What the metric readers read."""

    seconds: float
    setup_s: float
    arch: dict
    family: object
    recs: List[Rec]
    t0: float
    t1: float
    loop: str
    counters0: dict
    counters1: dict
    memory_peak_bytes: int = 0
    trace: Optional[prof_mod.Reduced] = None
    trace_ticks: int = 0
    trace_kv: List[list] = field(default_factory=list)
    on_card: bool = False
    profiled_at: Optional[float] = None  # host clock: the sub-window opened

    def delta(self, name: str) -> int:
        return self.counters1[name] - self.counters0[name]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str):
    spec = load_json(root / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    conf = load_json(root / conf_entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return spec, cell, conf, mix


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or workload in m["workloads"]]


def counters(eng) -> dict:
    return {k: int(getattr(eng.metrics, k)) for k in COUNTERS}


def build_engine(arch: dict, mix: dict, params, device, *, tracing: bool):
    from repro_torch.configs import ArchConfig
    from repro_torch.serving import EngineConfig, ServingEngine

    fields = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in arch.items()}
    cfg = ArchConfig(**fields)
    knobs = dict(mix["engine"])
    return ServingEngine(cfg, params, EngineConfig(tracing=tracing, **knobs),
                         device=device)


def make_request(i: int, prompt, max_new: int, greedy: bool, seed: int,
                 sampling: dict, now: float):
    from repro_torch.serving import Request, SamplingParams

    sp = SamplingParams() if greedy else SamplingParams(seed=seed, **sampling)
    return Request(rid=i, prompt=np.asarray(prompt, np.int32),
                   max_new_tokens=int(max_new), arrival_time=now, sampling=sp)


def run_to_end(eng, reqs, clock):
    """Submit ``reqs`` together and step until every one is done."""
    for r in reqs:
        eng.submit(r, clock())
    left = {id(r) for r in reqs}
    while left:
        for r in eng.step(clock()):
            left.discard(id(r))
        bad = [r for r in reqs if id(r) in left
               and r.state.name in ("FAILED", "CANCELLED", "TIMED_OUT")]
        if bad:
            raise RuntimeError(f"set-up request {bad[0].rid} ended "
                               f"{bad[0].state.name}: {bad[0].fail_reason}")
    eng.drain(clock())


def warm_requests(eng, tr: traffic_mod.Traffic, mix: dict, clock) -> list:
    """One request per engine path this traffic's prompts reach (each
    bucket, chunked, or the shortest and longest exact length), half of
    them seeded, each long enough to run single ticks and a fused window;
    with documents, a short document and questions on it (a first hit
    and a copy-on-write hit per question length class)."""
    sync = eng.sync_every
    new = 3 * sync + 2
    samp = mix["sampling"]
    rng = np.random.default_rng(7)
    vocab = eng.cfg.vocab_size
    if tr.documents:
        lens = sorted({len(r.prompt) - len(tr.documents[r.doc])
                       for r in tr.requests})
    else:
        lens = sorted({len(r.prompt) for r in tr.requests})

    def key(n):
        probe = make_request(0, np.zeros(n, np.int32), 1, True, 0, samp, 0.0)
        if eng.paged and eng._chunkable(probe):
            return "chunked"
        return eng._prefill_len(probe) if eng.bucket_prompts else None

    chosen = {}
    for n in lens:
        chosen.setdefault(key(n), n)
    picks = sorted(set(chosen.values()) | {lens[0], lens[-1]})
    out = []
    if tr.documents:
        tail = len(tr.documents[0]) % eng.page_size
        doc = rng.integers(0, vocab, 8 * eng.page_size + tail,
                           dtype=np.int32)
        run_to_end(eng, [make_request(10 ** 6, doc, 1, True, 0, samp,
                                      clock())], clock)
        for j, n in enumerate(picks):
            for k in range(2):
                q = rng.integers(0, vocab, n, dtype=np.int32)
                out.append(make_request(10 ** 6 + 1 + 2 * j + k,
                                        np.concatenate([doc, q]), new,
                                        k == 0, 1 + j, samp, clock()))
        return out
    return [make_request(10 ** 6 + j, rng.integers(0, vocab, n,
                                                   dtype=np.int32),
                         new, j % 2 == 0, 1 + j, samp, clock())
            for j, n in enumerate(picks)]


def warm(eng, tr, mix, clock):
    reqs = warm_requests(eng, tr, mix, clock)
    if tr.documents:  # hits come in order: each first hit, then its COW
        for r in reqs:
            run_to_end(eng, [r], clock)
    else:
        run_to_end(eng, reqs, clock)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    eng.reset()


def traffic_setup(eng, tr, clock):
    """The traffic's own set-up: each document prefilled once, so its
    full pages sit in the prefix cache."""
    for i, doc in enumerate(tr.documents):
        run_to_end(eng, [make_request(2 * 10 ** 6 + i, doc, 1, True, 0, {},
                                      clock())], clock)


class Labeller:
    """The traced run's host annotations: each labelled engine method and
    each step graph run inside a ``record_function`` span, and the live
    slots' positions at every decode step the profiled window holds (what
    the paged-decode roofline's bytes are counted from)."""

    def __init__(self, eng):
        self.eng = eng
        self.on = False
        self.kv: List[list] = []
        self.ticks = 0
        for name in LABELLED:
            if hasattr(eng, name):
                setattr(eng, name, self._wrap(name, getattr(eng, name)))
        run = eng.graphs.run

        def graphs_run(kind, name, n, step, **kw):
            if self.on and kind == "decode":
                live = [p for p, d in zip(eng._pos_h, eng.decoding) if d]
                for t in range(n):
                    self.kv.append([p + t + 1 for p in live])
                self.ticks += n
            with torch.profiler.record_function(
                    f"{prof_mod.LABEL}step {kind}/{name}{n}"):
                return run(kind, name, n, step, **kw)

        eng.graphs.run = graphs_run

    @staticmethod
    def _wrap(name, fn):
        label = f"{prof_mod.LABEL}engine.{name}"

        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped


class SubWindow:
    """The traced run's ``torch.profiler`` (CPU and CUDA activities) over
    one steady sub-window: it opens at ``PROFILE_AT`` of the window and
    lasts ``PROFILE_S`` at most, between engine calls, each edge after a
    device synchronize; the labeller records decode positions inside."""

    def __init__(self, labeller: Labeller):
        self.labeller = labeller
        self.prof = self.span = None
        self.at = 0.0
        self.done = False

    def tick(self, now: float, t0: float, seconds: float):
        if self.done:
            return
        if self.prof is None:
            if now >= t0 + PROFILE_AT * seconds:
                self._start(now)
        elif now >= self.at + PROFILE_S or now >= t0 + seconds:
            self.stop()

    def _start(self, now: float):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(prof_mod.WINDOW)
        self.span.__enter__()
        self.at = now
        self.labeller.on = True

    def stop(self):
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.labeller.on = False
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True


class StepTally:
    """Where the window's host time went, for standard error only (no
    metric reads it): the engine steps inside the window that ran a
    prefill or a chunk and those that did not, each with its count and
    its wall seconds, and the garbage collector's pauses there."""

    def __init__(self, eng, clock):
        self.eng, self.clock = eng, clock
        self.t1: Optional[float] = None
        self.n = {"prefill": 0, "decode": 0}
        self.s = {"prefill": 0.0, "decode": 0.0}
        self.gc_n, self.gc_s, self._gc_at = 0, 0.0, None
        gc.callbacks.append(self._gc)

    def open(self, t0: float, t1: float):
        self.t1 = t1

    def _inside(self, now: float) -> bool:
        return self.t1 is not None and now < self.t1

    def _gc(self, phase, info):
        now = self.clock()
        if phase == "start":
            self._gc_at = now if self._inside(now) else None
        elif self._gc_at is not None:
            self.gc_n += 1
            self.gc_s += now - self._gc_at
            self._gc_at = None

    def step(self, now: float):
        m = self.eng.metrics
        before = (self.eng.prefill_calls, m.prefill_chunks)
        out = self.eng.step(now)
        if self._inside(now):
            k = ("prefill" if (self.eng.prefill_calls, m.prefill_chunks)
                 != before else "decode")
            self.n[k] += 1
            self.s[k] += self.clock() - now
        return out

    def close(self) -> dict:
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        return {"steps": dict(self.n), "step_s": dict(self.s),
                "gc_pauses": self.gc_n, "gc_s": self.gc_s}


def drive(eng, tr: traffic_mod.Traffic, mix: dict, seconds: float, clock,
          on_tick: Optional[Callable[[float], None]] = None,
          opened: Optional[Callable[[float], None]] = None,
          tally: Optional[StepTally] = None):
    """The measured window; ``opened(t0)`` is called as it opens. A
    closed loop with ``warm_start`` has its clients' first requests sent
    and prefilled before the window opens (the loop's own set-up), so the
    window starts from a full batch. ``tally`` times the window's engine
    steps. Returns (records, t0, t1)."""
    samp = mix["sampling"]
    step = tally.step if tally is not None else eng.step
    recs: List[Rec] = []
    live: List[Rec] = []
    t0 = clock()
    t1 = t0 + seconds
    grace = float(mix.get("grace_s", 0.0))

    def send(p, due, now):
        req = make_request(p.idx, p.prompt, p.max_new, p.greedy,
                           p.sample_seed, samp, due)
        rec = Rec(p.idx, p.prompt, p.greedy, now, due, req)
        recs.append(rec)
        live.append(rec)
        if not eng.submit(req, now):
            rec.failed = True

    def stamp():
        now = clock()
        done = []
        for rec in live:
            n = len(rec.req.output)
            if n > rec.n_out:
                if rec.first is None:
                    rec.first = now
                rec.last, rec.n_out = now, n
                if now <= t1:
                    rec.n_win, rec.last_win = n, now
            state = rec.req.state.name
            if state == "FINISHED":
                done.append(rec)
            elif state in ("FAILED", "CANCELLED", "TIMED_OUT"):
                rec.failed = True
                done.append(rec)
        for rec in done:
            live.remove(rec)
        return now, done

    if tr.loop == "open":
        plan = sorted(tr.requests, key=lambda p: p.due)
        k = 0
        if opened is not None:
            opened(t0)
        if tally is not None:
            tally.open(t0, t1)
        while True:
            now = clock()
            while k < len(plan) and t0 + plan[k].due <= now:
                send(plan[k], t0 + plan[k].due, now)
                k += 1
                now, _ = stamp()
            if on_tick is not None:
                on_tick(now)
            if k >= len(plan) and not live:
                break
            if now > t1 + grace:
                break
            if eng.idle and not live:
                wait = t0 + plan[k].due - clock()
                if wait > 0.002:
                    time.sleep(wait - 0.001)
                continue
            step(now)
            stamp()
    else:
        pool = iter(tr.requests)

        def next_planned():
            p = next(pool, None)
            if p is None:
                raise RuntimeError(f"the mix's pool of {len(tr.requests)} "
                                   f"requests ran out inside the window")
            return p

        for _ in range(tr.clients):
            now = clock()
            send(next_planned(), now, now)
            stamp()
        if mix.get("warm_start"):
            while any(r.first is None and not r.failed for r in live):
                eng.step(clock())
                stamp()
            t0 = clock()
            t1 = t0 + seconds
            for rec in recs:
                rec.n_open = rec.n_out
                rec.n_win, rec.last_win = rec.n_out, None
        if opened is not None:
            opened(t0)
        if tally is not None:
            tally.open(t0, t1)
        while True:
            now = clock()
            if on_tick is not None:
                on_tick(now)
            if now >= t1:
                break
            step(now)
            now, done = stamp()
            for _ in done:
                if now < t1:
                    send(next_planned(), now, now)
                    stamp()
    eng.drain(clock())
    stamp()
    for rec in recs:
        t = rec.req.trace
        if t is not None:
            q = next((s for s in t.spans if s.kind == "queued"), None)
            if q is not None and q.t1 is not None:
                rec.queue_end = q.t1
    return recs, t0, t1


#: what can take the program's place in ``judge``, its tokens scored as
#: the program's are: "fp8" the control (the reference with every
#: projection in float8 e4m3: its argmax on greedy rows, its own top-k /
#: top-p draw on seeded rows); "top", a sampler that always takes the top
#: token of the set; "hot", one that ignores the temperature (T 1);
#: "ref", the float32 reference's own draws (the null of ``sampled_z``).
STAND_INS = ("fp8", "top", "hot", "ref")


def judge(ref, arch, params, recs, check: dict, seed: int, sampling: dict,
          stand_ins=()) -> dict:
    """The reference's comparison of what the window served: a sample of
    requests (``traffic.check_sample``) run whole through the float32
    reference from prompt and served tokens, then each served token
    scored (``score``). Returns {"program": readings} and, for each name
    in ``stand_ins``, the readings of that stand-in's tokens at the same
    positions."""
    done = [r for r in recs if r.n_out >= 1]
    sample = traffic_mod.check_sample(done, check, seed)
    device = params["embed"].device
    seqs, spans, toks = [], [], []
    for r in sample:
        out = np.asarray(r.req.output[:r.n_out], np.int32)
        seqs.append(torch.from_numpy(np.concatenate(
            [r.prompt, out[:-1]]).astype(np.int64)).to(device))
        spans.append((r.prompt_len - 1, r.prompt_len - 1 + len(out)))
        toks.append(torch.from_numpy(out.astype(np.int64)).to(device))
    unfinished = sum(1 for r in recs if r.failed)
    greedy = [r.greedy for r in sample]
    logits = ref.logits_at(arch, params, seqs, spans) if sample else []
    res = {"program": score(greedy, logits, toks, sampling, unfinished)}
    lc = (ref.logits_at(arch, params, seqs, spans, precision="fp8")
          if sample and "fp8" in stand_ins else None)
    for i, name in enumerate(stand_ins):
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) + i) % (1 << 63))
        picks = []
        for j, (g, lg) in enumerate(zip(greedy, logits)):
            src = lc[j] if name == "fp8" else lg
            if g or name == "top":
                picks.append(src.argmax(dim=-1))
            else:
                samp = (dict(sampling, temperature=1.0) if name == "hot"
                        else sampling)
                picks.append(draw_kept(src, samp, gen))
        res[name] = score(greedy, logits, picks, sampling, unfinished)
    return res


def score(greedy, logits, toks, sampling: dict, unfinished: int) -> dict:
    """Readings of tokens ``toks`` against the reference's ``logits`` at
    the same positions. ``greedy_gap``: the widest gap by which a greedy
    row's token's logit lies below the reference's best.
    ``sampled_gap``: how far (logit / T) a seeded row's token lies below
    the least logit that the reference's top-k / top-p set at the
    temperature keeps (0 inside the set). ``sampled_z``: |z| of the
    seeded rows' tokens' log-probabilities under the reference's kept
    distribution, against their mean and variance under it: about 1 for
    draws from that distribution, far above for a sampler that takes the
    top of the set or ignores the temperature."""
    out = {"greedy_gap": 0.0, "sampled_gap": 0.0, "sampled_z": 0.0,
           "greedy_tokens": 0, "sampled_tokens": 0,
           "greedy_flip_pct": 0.0, "unfinished": unfinished}
    flips, dev, var = 0, 0.0, 0.0
    for g, lg, tk in zip(greedy, logits, toks):
        got = lg.gather(1, tk[:, None])[:, 0]
        if g:
            gap = lg.max(dim=-1).values - got
            out["greedy_gap"] = max(out["greedy_gap"], float(gap.max()))
            out["greedy_tokens"] += len(tk)
            flips += int((gap > 0).sum())
        else:
            edge = kept_edge(lg, sampling)
            over = (edge - got / sampling["temperature"]).clamp(min=0)
            out["sampled_gap"] = max(out["sampled_gap"], float(over.max()))
            out["sampled_tokens"] += len(tk)
            d, v = log_prob_terms(lg, tk, sampling)
            dev, var = dev + d, var + v
    if out["greedy_tokens"]:
        out["greedy_flip_pct"] = 100.0 * flips / out["greedy_tokens"]
    if var > 0:
        out["sampled_z"] = abs(dev) / var ** 0.5
        out["sampled_z_signed"] = dev / var ** 0.5
    return out


def _kept(logits, sampling: dict):
    """The top-k / top-p set of ``logits`` at the temperature, per row:
    its temperature-scaled values (descending), token ids, and size. The
    k largest; of those, the fewest largest whose softmax mass reaches
    top_p."""
    x = logits / sampling["temperature"]
    k = min(int(sampling["top_k"]), x.shape[-1]) if sampling["top_k"] > 0 \
        else x.shape[-1]
    vals, idx = x.topk(k, dim=-1)
    p = torch.softmax(vals.double(), dim=-1).cumsum(dim=-1)
    n_keep = ((p < sampling["top_p"]).sum(dim=-1) + 1).clamp(max=k)
    return vals, idx, n_keep


def kept_edge(logits, sampling: dict):
    """Per row, the least temperature-scaled logit the set keeps."""
    vals, _, n_keep = _kept(logits, sampling)
    return vals.gather(1, (n_keep - 1)[:, None])[:, 0]


def log_prob_terms(logits, toks, sampling: dict):
    """Over rows: the sum of (log q(token) - E_q[log q]) and of Var_q[log
    q], q the reference's kept distribution (softmax of the kept set's
    scaled logits); a token outside the set is scored by its scaled logit
    against the set's normaliser, so it reads below every kept token."""
    vals, _, n_keep = _kept(logits.double(), sampling)
    keep = torch.arange(vals.shape[-1], device=vals.device) < n_keep[:, None]
    vals = vals.masked_fill(~keep, -torch.inf)
    lse = torch.logsumexp(vals, dim=-1)
    lq = (vals - lse[:, None]).masked_fill(~keep, 0.0)
    q = torch.exp(vals - lse[:, None])
    mean = (q * lq).sum(dim=-1)
    var = (q * lq * lq).sum(dim=-1) - mean * mean
    got = logits.double().gather(1, toks[:, None])[:, 0] / sampling["temperature"]
    return float((got - lse - mean).sum()), float(var.clamp(min=0).sum())


def draw_kept(logits, sampling: dict, gen):
    """One token per row drawn from the top-k / top-p set of ``logits`` at
    the temperature (inverse CDF with a uniform from ``gen``)."""
    vals, idx, n_keep = _kept(logits, sampling)
    p = torch.softmax(vals.double(), dim=-1).cumsum(dim=-1)
    total = p.gather(1, (n_keep - 1)[:, None])
    u = torch.rand(total.shape, generator=gen, device=vals.device,
                   dtype=torch.float64) * total
    j = torch.minimum((p <= u).sum(dim=-1), n_keep - 1)
    return idx.gather(1, j[:, None])[:, 0]


def checks_of(readings: dict, limits: dict) -> dict:
    return {k: {"value": readings[k], "limit": limits[k]}
            for k in limits if k in readings}


def is_correct(readings: dict, limits: dict) -> bool:
    return (bool(limits) and readings["greedy_tokens"] > 0
            and all(readings[k] <= lim for k, lim in limits.items()))


def free_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path, t_start: float, device="cuda", arch=None, mix=None,
             fault: Optional[Callable] = None, control: Optional[str] = None,
             also=(), limits: Optional[dict] = None) -> dict:
    """One run. ``arch`` / ``mix`` replace the cell's configuration and
    traffic (CPU tests at a tiny size); ``fault`` is applied to the built
    engine (tests that break the timed path); ``control`` names a stand-in
    (``STAND_INS``) put in the program's place: its readings decide
    ``correct``. The readings of the program and of each stand-in in
    ``control`` and ``also`` are under ``readings_of``."""
    spec, cell, conf, cell_mix = load_cell(root, workload)
    arch = arch or conf["arch"]
    mix = mix or cell_mix
    if limits is None:
        path = HERE / "limits" / f"{workload}.json"
        limits = load_json(path)["limits"] if path.exists() else {}
    family = importlib.import_module(f"ldsbench.families.{conf['family']}")
    ref = importlib.import_module(f"ldsbench.reference.{conf['family']}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    clock = time.perf_counter

    params = family.make_weights(arch, seed, device)
    tr = traffic_mod.build(mix, arch["vocab_size"], seed, seconds)
    eng = build_engine(arch, mix, params, device, tracing=trace)
    if fault is not None:
        fault(eng)
    warm(eng, tr, mix, clock)
    traffic_setup(eng, tr, clock)
    if cuda:
        torch.cuda.synchronize()
    labeller = Labeller(eng) if trace else None
    c0 = counters(eng)
    opened_at = []

    def opened(t0):
        opened_at.append(t0)
        captures.append(eng.graphs.captures)

    captures = []

    profiled = SubWindow(labeller) if (trace and cuda) else None

    def on_tick(now):
        if profiled is not None:
            profiled.tick(now, opened_at[0], seconds)

    tally = StepTally(eng, clock)
    recs, t0, t1 = drive(eng, tr, mix, seconds, clock, on_tick=on_tick,
                         opened=opened, tally=tally)
    host = tally.close()
    tally = None
    captures.append(eng.graphs.captures)
    setup_s = t0 - t_start
    if profiled is not None:
        profiled.stop()
    c1 = counters(eng)
    if cuda:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    run = Run(seconds, setup_s, arch, family, recs, t0, t1,
              tr.loop, c0, c1, memory_peak_bytes=peak,
              on_card=cuda)
    if profiled is not None and profiled.prof is not None:
        run.trace = prof_mod.from_profiler(profiled.prof)
        run.trace_ticks = labeller.ticks
        run.trace_kv = labeller.kv
        run.profiled_at = profiled.at
    labeller = None
    del eng  # the engine's caches go before the reference runs
    free_memory()
    stand_ins = tuple(dict.fromkeys(((control,) if control else ()) + also))
    readings_of = judge(ref, arch, params, recs, mix["check"], seed,
                        mix["sampling"], stand_ins)
    readings = readings_of[control or "program"]
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        reader = importlib.import_module(f"ldsbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    props = torch.cuda.get_device_properties(device) if cuda else None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": props.name if cuda else "cpu", "count": 1,
           "memory_peak_bytes": peak}
    out = {"correct": is_correct(readings, limits),
           "attempted": len(recs),
           "failed": readings["unfinished"],
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = prof_mod.breakdown(run.trace)
    out["samples"] = sample_counts(run)
    # a step graph captured inside the window would be a compile there
    out["samples"]["captures_in_window"] = captures[1] - captures[0]
    out["samples"]["host"] = host
    out["readings"] = readings
    if stand_ins:
        out["readings_of"] = readings_of
    out["checks"] = checks_of(readings, limits)
    return out


def sample_counts(run: Run) -> dict:
    return {"ttft": len(_common.ttfts(run)), "tpot": len(_common.tpots(run)),
            "tokens_in_window": _common.tokens_in_window(run)}

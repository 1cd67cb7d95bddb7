"""Fault injection for the serving cluster (chaos testing); the port's copy
of the JAX package's ``serving/faults.py``.

Production inference lives with machine failures as the norm (the
Facebook datacenter study: co-location interference, capacity pressure,
host loss), so the cluster frontend's failover path must be exercisable
deterministically. This module provides the instruments:

  * ``EngineFailure`` — what a dead replica's RPC layer would surface:
    raised by a killed engine's ``step``/``submit``; the frontend catches
    it, deregisters the replica, and fails over its outstanding work;
  * ``FaultyEngine`` — a transparent proxy over a live ``ServingEngine``
    that a ``FaultInjector`` arms. Modes:
      - ``kill``: every ``step``/``submit`` raises ``EngineFailure``
        (crashed host — detection is immediate at the next step);
      - ``hang``: ``step`` returns nothing and makes NO progress while
        the engine keeps accepting work (wedged host — only the
        frontend's staleness watchdog can catch it);
      - ``slow``: only every ``slow_every``-th ``step`` actually runs
        (co-tenant interference / failing disk; mild slowness survives
        via the closed-loop residual, pathological slowness trips the
        watchdog like a hang);
      - ``recover``: back to healthy forwarding.
  * ``FaultInjector`` — a deterministic virtual-time schedule of fault
    events over named proxies.

The proxy forwards every attribute read AND write to the wrapped engine
(``ClusterFrontend.add_engine`` sets ``engine.edf_backlog``), so it can
stand anywhere a ``ServingEngine`` does.

A frontend built with a ``CircuitBreaker`` (``serving/overload.py``) layers
recovery discipline over these faults: an ``EngineFailure`` trips the
replica's breaker open (routing excludes it), ``revive()`` resets it,
and a half-open replica takes only bounded probe traffic until it
proves itself — so chaos-injected flapping can't turn the failover
retry path into a retry storm.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple


class EngineFailure(RuntimeError):
    """A replica stopped serving (crashed / unreachable). Raised by a
    killed ``FaultyEngine``; the ``ClusterFrontend`` catches it, marks
    the instance failed, and re-submits its outstanding requests to
    survivors."""


_KINDS = ("kill", "hang", "slow", "recover")


class FaultyEngine:
    """Transparent ``ServingEngine`` proxy with an injectable fault mode."""

    _LOCAL = frozenset({"_eng", "mode", "slow_every", "_skips"})

    def __init__(self, engine):
        object.__setattr__(self, "_eng", engine)
        object.__setattr__(self, "mode", None)
        object.__setattr__(self, "slow_every", 1)
        object.__setattr__(self, "_skips", 0)

    # -- proxy plumbing ----------------------------------------------------
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_eng"), name)

    def __setattr__(self, name, value):
        if name in type(self)._LOCAL:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_eng"), name, value)

    @property
    def engine(self):
        """The wrapped live engine (post-mortem inspection in tests)."""
        return object.__getattribute__(self, "_eng")

    # -- fault arming ------------------------------------------------------
    def inject(self, kind: str, *, slow_every: int = 4):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (want {_KINDS})")
        self.mode = None if kind == "recover" else kind
        if kind == "slow":
            self.slow_every = max(2, slow_every)

    # -- intercepted engine surface ---------------------------------------
    def step(self, now: float):
        if self.mode == "kill":
            raise EngineFailure("replica killed (fault injection)")
        if self.mode == "hang":
            return []  # no error, no progress: watchdog territory
        if self.mode == "slow":
            self._skips += 1
            if self._skips % self.slow_every:
                return []
        return self.engine.step(now)

    def submit(self, req, now: float):
        if self.mode == "kill":
            raise EngineFailure("replica killed (fault injection)")
        # a hung replica still ACCEPTS work (the insidious case: requests
        # sink into its queue until the watchdog declares it dead)
        return self.engine.submit(req, now)

    def drain(self, now: float):
        if self.mode in ("kill", "hang"):
            return []
        return self.engine.drain(now)


class FaultInjector:
    """Deterministic fault schedule over named ``FaultyEngine`` proxies.

    ``schedule(t, name, kind)`` registers an event; ``tick(now)`` (called
    once per virtual-time step, before the cluster steps) fires every
    event due at or before ``now`` and returns the fired
    ``(t, name, kind)`` triples. No wall clock, no randomness — a chaos
    run is exactly reproducible from its schedule.
    """

    def __init__(self, proxies: Dict[str, FaultyEngine]):
        self.proxies = dict(proxies)
        self._events: List[Tuple[float, int, str, str, int]] = []
        self._seq = itertools.count()
        self.fired: List[Tuple[float, str, str]] = []

    def schedule(self, t: float, name: str, kind: str, *,
                 slow_every: int = 4):
        if name not in self.proxies:
            raise KeyError(f"no proxy named {name!r} "
                           f"(have {sorted(self.proxies)})")
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (want {_KINDS})")
        heapq.heappush(self._events,
                       (t, next(self._seq), name, kind, slow_every))

    def tick(self, now: float) -> List[Tuple[float, str, str]]:
        out = []
        while self._events and self._events[0][0] <= now:
            t, _, name, kind, slow_every = heapq.heappop(self._events)
            self.proxies[name].inject(kind, slow_every=slow_every)
            out.append((t, name, kind))
        self.fired.extend(out)
        return out

    @property
    def pending(self) -> int:
        return len(self._events)

"""Pluggable load-balancing strategies for the HTTP proxy.

A strategy picks the engine a NEW session should first land on; the
pick feeds ``ServingRuntime.submit(route_hint=...)``, a one-shot hint
consumed on the session's first dispatch.  Returning ``None`` defers to
the scheduler's own Eq. 7 affinity routing — that is the saga-affinity
strategy, and the default.  Later steps of a session always follow the
scheduler (park/resume affinity is the paper's whole point); strategies
only spread FIRST placements, e.g. to keep a canary engine cold or to
mimic a front-end LB the paper's baselines assume.

Strategies are registered by name so deployments select them from
config (``SagaHTTPProxy(strategy="least-loaded")``); ``register_strategy``
admits out-of-tree implementations.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Type


class Strategy:
    """Pick an engine for a first placement, or ``None`` to defer to
    Eq. 7.  ``loads`` is the per-engine active-session count, ``alive``
    the liveness mask, ``roles`` the engine roles (``prefill`` engines
    hold no decode slots and must not be picked)."""

    name = "base"

    def pick(self, session_key: str, loads: Sequence[float],
             alive: Sequence[bool],
             roles: Sequence[str]) -> Optional[int]:
        raise NotImplementedError

    def _eligible(self, loads, alive, roles):
        return [w for w in range(len(loads))
                if alive[w] and roles[w] != "prefill"]


class SagaAffinity(Strategy):
    """Defer every placement to the scheduler's Eq. 7 routing (cache
    affinity + load threshold).  The default — byte-identical to not
    running a proxy at all."""

    name = "saga-affinity"

    def pick(self, session_key, loads, alive, roles) -> Optional[int]:
        return None


class RoundRobin(Strategy):
    """Cycle over live decode-capable engines in index order."""

    name = "round-robin"

    def __init__(self) -> None:
        self._next = itertools.count()

    def pick(self, session_key, loads, alive, roles) -> Optional[int]:
        ok = self._eligible(loads, alive, roles)
        if not ok:
            return None
        return ok[next(self._next) % len(ok)]


class LeastLoaded(Strategy):
    """Lowest active-session count among live decode-capable engines;
    ties break to the lowest index (deterministic)."""

    name = "least-loaded"

    def pick(self, session_key, loads, alive, roles) -> Optional[int]:
        ok = self._eligible(loads, alive, roles)
        if not ok:
            return None
        return min(ok, key=lambda w: (loads[w], w))


_REGISTRY: Dict[str, Type[Strategy]] = {}


def register_strategy(cls: Type[Strategy]) -> Type[Strategy]:
    if not cls.name or cls.name in _REGISTRY:
        raise ValueError(f"strategy name {cls.name!r} empty or taken")
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (SagaAffinity, RoundRobin, LeastLoaded):
    register_strategy(_cls)


def get_strategy(name: str) -> Strategy:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown strategy {name!r} "
                         f"(have {sorted(_REGISTRY)})") from None

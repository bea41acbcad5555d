"""Global coordinator: the workflow-atomic scheduling brain (paper §3.1).

Wires AEGs + WA-LRU + TTL + affinity + stealing + AFS + prefetch into a
single object used by BOTH the discrete-event simulator
(``repro_torch.cluster.simulator``) and the real JAX serving engine
(``repro_torch.serving.server``).  All methods take explicit ``now`` so the
coordinator is time-source agnostic.

Cross-layer behaviours from §3.1:
  * AFS preemption migrates cache WITH its TTL state, so WA-LRU at the
    destination keeps honoring the prediction (``migrate_session``).
  * Work stealing is gated by both T_idle and R_max (in WorkStealer).
  * Coordinator state is checkpointable (``snapshot``/``restore``) —
    fault tolerance for 1000+-node deployments.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field, asdict
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

try:
    import numpy as np
except ImportError:          # pragma: no cover - numpy ships with repo
    np = None

INF = float("inf")

from repro_torch.core.aeg import AEG, PatternInferencer, ToolStats
from repro_torch.core.affinity import SessionRouter
from repro_torch.core.afs import AFSScheduler, TaskProgress
from repro_torch.core.prefetch import SpeculativePrefetcher
from repro_torch.core.stealing import StealDecision, WorkStealer
from repro_torch.core.ttl import ToolTTLPolicy, memory_pressure
from repro_torch.core.walru import (CacheEntry, EvictionWeights, LRUCache,
                              PrefixLRUCache, WALRUCache)


_CACHE_POLICIES = ("walru", "lru", "prefix", "none")
_OBS_TIERS = ("hints", "pattern", "none")


@dataclass(kw_only=True)
class SAGAConfig:
    """Scheduling knobs for both substrates.  Keyword-only: every field
    has a default and positional construction has never been supported
    by any in-tree call site, so argument order can no longer silently
    change meaning.  ``validate()`` is the single coherence gate
    (replacing scattered asserts); the full field table lives in
    docs/SERVING_API.md."""

    # WA-LRU (Eq. 1, Table 9)
    alpha: float = 0.3
    beta: float = 0.5
    gamma: float = 0.2
    # routing (Eq. 7)
    theta: float = 0.8
    # stealing (§5.2)
    t_idle_s: float = 0.100
    r_max: float = 2.0
    # TTL (Algorithm 1 / Eq. 6)
    ttl_percentile: float = 95.0
    ttl_max_s: float = 300.0
    th_low: float = 0.7
    th_high: float = 0.9
    # AEG inference (§3.3)
    theta_conf: float = 0.7
    min_tasks: int = 30
    # AFS (§6)
    epoch_s: float = 0.100
    preempt_block_s: float = 0.500
    # AFS preemption of RUNNING decodes (§6.2 step 4, serving runtime):
    # a queued session whose tenant's fair-share deficit against a
    # running victim exceeds ``preempt_deficit`` for longer than
    # ``preempt_block_s`` parks the victim at the next batched-decode
    # round boundary.  Off by default: admission-only ordering is the
    # pre-preemption behaviour every golden byte-pin was captured under.
    enable_preemption: bool = False
    preempt_deficit: float = 0.0
    # observability tier: hints | pattern | none
    observability: str = "hints"
    # cache policy: walru | lru | prefix | none (no cross-request reuse,
    # vLLM v0.6.0 discards KV at request end)
    cache_policy: str = "walru"
    prefix_fraction: float = 0.35
    # component toggles (Table 4 ablations)
    enable_affinity: bool = True
    enable_stealing: bool = True
    enable_ttl: bool = True
    enable_prefetch: bool = True
    enable_afs: bool = True
    # disaggregated prefill/decode engine pools (serving runtime §5 /
    # ROADMAP item 2).  Off by default: the unified pool is the
    # behaviour every committed fingerprint was captured under.  When
    # on, the runtime splits engines into prefill / decode roles, a
    # PrefillScheduler owns prefill placement, and Eq. 7 affinity
    # routing decides decode placement only (see serving/disagg.py).
    disaggregate: bool = False
    seed: int = 0

    def validate(self, *, roles: Optional[Sequence[str]] = None,
                 n_workers: Optional[int] = None) -> "SAGAConfig":
        """Raise ``ValueError`` listing every incoherent setting, or
        return ``self`` so construction sites can chain.  ``roles`` is
        the serving runtime's per-engine role list (``decode`` /
        ``prefill``); when given, role/disaggregation coherence is
        checked too.  Called from ``GlobalCoordinator.__init__`` so a
        bad config fails loudly on both substrates."""
        errs: List[str] = []

        def rng(name: str, lo: float, hi: float) -> None:
            v = getattr(self, name)
            if not lo <= v <= hi:
                errs.append(f"{name}={v!r} must be in [{lo}, {hi}]")

        for f in ("alpha", "beta", "gamma", "th_low", "th_high",
                  "theta_conf", "prefix_fraction"):
            rng(f, 0.0, 1.0)
        rng("ttl_percentile", 0.0, 100.0)
        # theta is a load threshold in engine-count units, not a
        # fraction: >1 deliberately over-commits toward affinity.
        for f in ("theta", "t_idle_s", "r_max", "ttl_max_s", "epoch_s",
                  "preempt_block_s"):
            if getattr(self, f) <= 0:
                errs.append(f"{f}={getattr(self, f)!r} must be > 0")
        if self.min_tasks < 1:
            errs.append(f"min_tasks={self.min_tasks!r} must be >= 1")
        if self.th_low > self.th_high:
            errs.append(f"th_low={self.th_low!r} must not exceed "
                        f"th_high={self.th_high!r}")
        if self.cache_policy not in _CACHE_POLICIES:
            errs.append(f"cache_policy={self.cache_policy!r} not one of "
                        f"{_CACHE_POLICIES}")
        if self.observability not in _OBS_TIERS:
            errs.append(f"observability={self.observability!r} not one "
                        f"of {_OBS_TIERS}")
        if self.preempt_deficit < 0:
            errs.append(f"preempt_deficit={self.preempt_deficit!r} must "
                        "be >= 0 (0 parks on any positive deficit)")
        if self.preempt_deficit > 0 and not self.enable_preemption:
            errs.append(f"preempt_deficit={self.preempt_deficit!r} has "
                        "no effect without enable_preemption=True")
        if self.enable_preemption and not self.enable_afs:
            errs.append("enable_preemption=True needs enable_afs=True "
                        "(preemption restores the AFS fair share)")
        if roles is not None:
            bad = sorted(set(roles) - {"decode", "prefill", "unified"})
            if bad:
                errs.append(f"unknown engine roles {bad!r} (want "
                            "'prefill', 'decode' or 'unified')")
            if n_workers is not None and len(roles) != n_workers:
                errs.append(f"{len(roles)} roles for {n_workers} engines")
            if "prefill" in roles and not self.disaggregate:
                errs.append("prefill-role engines need "
                            "SAGAConfig.disaggregate=True")
            if self.disaggregate and all(r == "prefill" for r in roles):
                errs.append("disaggregation needs a decode engine "
                            "(all-prefill cluster can serve nothing)")
        if errs:
            raise ValueError("invalid SAGAConfig: " + "; ".join(errs))
        return self


@dataclass
class SessionInfo:
    session_id: str
    tenant: str
    aeg: Optional[AEG]
    node_id: int = 0
    ctx_tokens: float = 0.0
    cur_tool: str = "unknown"
    tools_seen: List[str] = field(default_factory=list)
    prefix_tokens: float = 0.0
    # tier-a explicit graph (client-declared AEG): node advancement
    # follows the substrate-reported taken edge, prefetch targets the
    # resolved next node, and AFS work is re-estimated from Eq. 9
    declared: bool = False
    step_cost_s: float = 0.0      # mean GPU-seconds per step (Eq. 9)


class GlobalCoordinator:
    def __init__(self, cfg: SAGAConfig, n_workers: int,
                 worker_capacity_bytes: float):
        cfg.validate()
        self.cfg = cfg
        self.n_workers = n_workers
        self.capacity = worker_capacity_bytes
        self.sessions: Dict[str, SessionInfo] = {}
        self.stats = ToolStats()
        self.ttl = ToolTTLPolicy(p=cfg.ttl_percentile,
                                 ttl_max_s=cfg.ttl_max_s)
        self.router = SessionRouter(theta=cfg.theta)
        self.stealer = WorkStealer(t_idle_s=cfg.t_idle_s, r_max=cfg.r_max,
                                   seed=cfg.seed)
        self.afs = AFSScheduler(epoch_s=cfg.epoch_s,
                                preempt_block_s=cfg.preempt_block_s)
        self.prefetcher = SpeculativePrefetcher()
        self.inferencer = PatternInferencer(theta_conf=cfg.theta_conf,
                                            min_tasks=cfg.min_tasks)
        self.pools: List[WALRUCache] = [self._make_pool()
                                        for _ in range(n_workers)]
        self.alive = [True] * n_workers
        self._n_dead = 0
        if np is not None:
            self._alive_np = np.ones(n_workers, dtype=bool)
        # incremental aggregates: total cached bytes across pools and a
        # session -> {workers whose pool holds its entry} index, so
        # memory sampling and task teardown are O(sites touched), not
        # O(n_workers)
        self.pools_used = 0.0
        self._sites: Dict[str, Set[int]] = {}
        # disaggregated pools (cfg.disaggregate): workers the serving
        # runtime declared as prefill-role.  Routing masks them to INF
        # (Eq. 7 decides decode placement only) and they never enter the
        # work stealer's idle set.
        self.prefill_workers: Set[int] = set()
        # instrumentation
        self.cache_hits = 0
        self.cache_misses = 0
        self.regen_tokens = 0.0

    def set_worker_role(self, worker: int, role: str) -> None:
        """Declare a worker's engine role (``prefill`` / ``decode`` /
        ``unified``).  Only ``prefill`` changes behaviour: the worker is
        excluded from Eq. 7 routing and from the steal idle set."""
        if role == "prefill":
            self.prefill_workers.add(worker)
        else:
            self.prefill_workers.discard(worker)

    def cached_sites(self, session_id: str) -> Tuple[int, ...]:
        """Workers whose pool currently holds an entry for the session
        (home + prefetch replicas), sorted.  The serving runtime frees
        the matching real KV blocks when a task finishes."""
        return tuple(sorted(self._sites.get(session_id, ())))

    def _site_add(self, session_id: str, worker: int) -> None:
        self._sites.setdefault(session_id, set()).add(worker)

    def _site_discard(self, session_id: str, worker: int) -> None:
        s = self._sites.get(session_id)
        if s is not None:
            s.discard(worker)
            if not s:
                del self._sites[session_id]

    # ------------------------------------------------------------------
    def _make_pool(self) -> WALRUCache:
        w = EvictionWeights(self.cfg.alpha, self.cfg.beta, self.cfg.gamma)
        if self.cfg.cache_policy == "none":
            return LRUCache(0.0, w)          # nothing survives a request
        if self.cfg.cache_policy == "lru":
            return LRUCache(self.capacity, w)
        if self.cfg.cache_policy == "prefix":
            return PrefixLRUCache(self.capacity, w,
                                  prefix_fraction=self.cfg.prefix_fraction)
        return WALRUCache(self.capacity, w, p_reuse_fn=self._p_reuse)

    def _p_reuse(self, entry: CacheEntry) -> float:
        info = self.sessions.get(entry.session_id)
        if info is None or info.aeg is None:
            return 0.5
        return info.aeg.p_reuse(info.node_id, info.ctx_tokens, self.stats)

    # -- session lifecycle ----------------------------------------------
    def register_task(self, session_id: str, tenant: str,
                      planned_tools: Optional[Sequence[str]],
                      deadline: float, work_est_s: float,
                      now: float, prefix_tokens: float = 0.0,
                      aeg: Optional[AEG] = None,
                      step_cost_s: float = 0.0,
                      entry_node: int = 0) -> None:
        """Admit a workflow.  ``aeg`` is the client-declared execution
        graph (tier-a observability, §3.3): honored only when the
        scheduler is configured to see workflow hints — baselines that
        model request-level systems (``observability="none"``) stay
        blind even when the client declares, and ``"pattern"`` mode
        deliberately ignores hints to measure inference quality.  With
        a declared graph, node advancement follows the taken edge
        reported by the substrate (``on_step_end(next_node=...)``) and
        AFS work-remaining re-estimates from Eq. 9 each step."""
        declared = False
        node_id = 0
        if aeg is not None and self.cfg.observability == "hints":
            declared = True
            node_id = entry_node
        else:
            aeg = None
            if self.cfg.observability == "hints" and planned_tools:
                aeg = AEG.linear_chain(list(planned_tools))
            elif self.cfg.observability == "pattern":
                first = planned_tools[0] if planned_tools else "unknown"
                aeg = self.inferencer.infer(first)
        self.sessions[session_id] = SessionInfo(
            session_id, tenant, aeg, node_id=node_id,
            prefix_tokens=prefix_tokens, declared=declared,
            step_cost_s=step_cost_s)
        if self.cfg.enable_afs:
            self.afs.add_task(TaskProgress(session_id, tenant, deadline,
                                           work_est_s))

    def task_finished(self, session_id: str, now: float) -> None:
        info = self.sessions.pop(session_id, None)
        if info is not None:
            self.inferencer.record_trace(info.tools_seen)
        self.afs.finish_task(session_id)
        self.router.forget(session_id)
        # a prefetch issued during the final tool gap can never resolve:
        # account its copy as waste instead of leaking the job
        self.prefetcher.cancel(session_id)
        # only the workers whose pool actually holds the session (the
        # sites index) — not a cluster-wide sweep.  Explicit unpin
        # before removal: a hit entry pinned at the final step's start
        # must not survive as an unevictable ghost if removal is ever
        # made lazy.
        for w in sorted(self._sites.pop(session_id, ())):
            self.unpin(session_id, w)
            e = self.pools[w].remove(session_id)
            if e is not None:
                self.pools_used -= e.size_bytes

    # -- routing (Eq. 7) ---------------------------------------------------
    def route(self, session_id: str, loads: Sequence[float],
              now: float) -> int:
        if np is not None and isinstance(loads, np.ndarray):
            # numpy fast path (the simulator's incremental load vector):
            # dead-worker masking and argmin run in C
            if self._n_dead:
                loads = np.where(self._alive_np[:len(loads)], loads, INF)
            if self.prefill_workers:
                # disaggregated pools: Eq. 7 decides DECODE placement
                # only — prefill-role workers are never a routing target
                loads = loads.astype(float, copy=True)
                loads[sorted(self.prefill_workers)] = INF
            if not self.cfg.enable_affinity:
                return int(loads.argmin())
        else:
            loads = [INF if (not self.alive[i]
                             or i in self.prefill_workers) else l
                     for i, l in enumerate(loads)]
            if not self.cfg.enable_affinity:
                return min(range(len(loads)), key=lambda i: loads[i])
        return self.router.route(
            session_id, loads,
            cached=lambda w, s: self.pools[w].contains(s))

    # -- cache events -------------------------------------------------------
    def on_step_start(self, session_id: str, worker: int,
                      ctx_tokens: float, now: float
                      ) -> Tuple[bool, float, float]:
        """Session begins an LLM step on `worker`.  Returns
        (cache_hit, prefill_tokens, background_tokens):
          hit  -> (True, delta_since_cached, 0): only the tool
                  observation + new prompt prefill.
          miss + correct speculative prefetch -> (False, delta, suffix):
                  the suffix regeneration ran as BACKGROUND prefill
                  during the tool gap (the simulator charges it to the
                  worker's prefill server if it had idle capacity —
                  prefetch hides latency, never compute).
          miss -> (False, regen, 0): full (or radix-suffix) regeneration
                  on the critical path."""
        info = self.sessions.get(session_id)
        pool = self.pools[worker]
        entry = pool.lookup(session_id, now)
        prefetch_hit = False
        if info is not None and self.cfg.enable_prefetch:
            # declared graphs: the taken edge was resolved at the park
            # boundary, so the step being started IS node_id and the
            # prefetch (targeted at it) resolves exactly; linear-chain
            # sessions keep the legacy successor-id convention
            expected = info.node_id if info.declared \
                else info.node_id + 1
            prefetch_hit = self.prefetcher.resolve(
                session_id, expected, now)
        if entry is not None:
            entry.pinned = True
            self.cache_hits += 1
            return True, max(0.0, ctx_tokens - entry.tokens), 0.0
        self.cache_misses += 1
        regen = ctx_tokens
        if isinstance(pool, PrefixLRUCache) and info is not None:
            regen = max(0.0, ctx_tokens - info.prefix_tokens)
        if prefetch_hit and info is not None:
            cached = info.ctx_tokens
            delta = max(0.0, ctx_tokens - cached)
            self.regen_tokens += cached
            return False, delta, min(regen, cached)
        self.regen_tokens += regen
        return False, regen, 0.0

    def ensure_headroom(self, worker: int, active_kv_bytes: float,
                        required_bytes: float, now: float) -> int:
        """Evict idle entries until a new step's KV fits next to the
        running requests (vLLM preempts idle blocks the same way).
        Returns number of evictions."""
        pool = self.pools[worker]
        n = 0
        while (pool.used + active_kv_bytes + required_bytes > self.capacity
               and pool.entries):
            victim = pool.select_victim(now)
            if victim is None:
                break
            pool.remove(victim.session_id)
            self.pools_used -= victim.size_bytes
            self._site_discard(victim.session_id, worker)
            pool.evictions += 1
            pool.bytes_evicted += victim.size_bytes
            n += 1
        return n

    def drop_entry(self, session_id: str, worker: int,
                   count_eviction: bool = True) -> Optional[CacheEntry]:
        """Remove one pool entry and keep every aggregate (bytes total,
        sites index, eviction counters) in sync.  The serving runtime's
        event-driven WA-LRU reconciliation uses this instead of the old
        per-step scan over every cached session."""
        pool = self.pools[worker]
        e = pool.remove(session_id)
        if e is None:
            return None
        self.pools_used -= e.size_bytes
        self._site_discard(session_id, worker)
        if count_eviction:
            pool.evictions += 1
            pool.bytes_evicted += e.size_bytes
        return e

    def replicate_entry(self, session_id: str, src: int, dst: int,
                        now: float) -> Tuple[bool, List[CacheEntry]]:
        """Speculative prefetch landing (§4.3): clone ``src``'s pool
        entry into ``dst`` — the source keeps its copy, unlike
        ``migrate_session``.  Returns (inserted, evicted_at_dst) so the
        caller can mirror the real KV blocks (copy on success, evict the
        victims' blocks either way)."""
        e = self.pools[src].entries.get(session_id)
        if e is None or self.pools[dst].contains(session_id):
            return False, []
        clone = CacheEntry(session_id=session_id, size_bytes=e.size_bytes,
                           t_last=now, tokens=e.tokens, node_id=e.node_id,
                           ttl_deadline=e.ttl_deadline)
        dst_pool = self.pools[dst]
        used_before = dst_pool.used
        evicted = dst_pool.insert(clone, now)
        self.pools_used += dst_pool.used - used_before
        for ev in evicted:
            self._site_discard(ev.session_id, dst)
        if dst_pool.contains(session_id):
            self._site_add(session_id, dst)
            return True, evicted
        return False, evicted

    def unpin(self, session_id: str, worker: int) -> None:
        """Release the decode-time pin taken by ``on_step_start`` on a
        cache hit.  Called on step end and task finish; without it a
        pinned entry is only released by wholesale replacement, which a
        cancelled (fault-aborted) step never performs."""
        e = self.pools[worker].entries.get(session_id)
        if e is not None:
            e.pinned = False

    def on_step_end(self, session_id: str, worker: int, ctx_tokens: float,
                    entry_bytes: float, next_tool: str, now: float,
                    next_node: Optional[int] = None) -> List[CacheEntry]:
        """LLM step done; session enters a tool call.  Unpins the
        step's hit entry, then inserts/updates the cache entry with a
        tool-aware TTL and maybe issues a prefetch.  ``next_node`` is
        the AEG node the *taken edge* leads to (declared graphs —
        branch/retry structure); None keeps the legacy linear
        advancement.  Returns evicted entries."""
        self.unpin(session_id, worker)
        info = self.sessions.get(session_id)
        if info is not None:
            info.node_id = info.node_id + 1 if next_node is None \
                else next_node
            info.ctx_tokens = ctx_tokens
            info.cur_tool = next_tool
            info.tools_seen.append(next_tool)
            if (self.cfg.observability == "pattern"
                    and info.aeg is not None):
                info.aeg = self.inferencer.infer(next_tool)
            if (info.declared and info.aeg is not None
                    and info.step_cost_s > 0.0 and self.cfg.enable_afs):
                # Eq. 9 on the true branch structure: expected remaining
                # steps from the node the taken edge reached
                self.afs.set_work(
                    session_id,
                    info.aeg.work_remaining_steps(info.node_id)
                    * info.step_cost_s)
        evicted = self._insert_ttl_entry(session_id, worker, ctx_tokens,
                                         entry_bytes, next_tool, now,
                                         info.node_id if info else 0)
        pool = self.pools[worker]
        if info is not None and self.cfg.enable_prefetch:
            # declared graphs prefetch the RESOLVED next node (the taken
            # edge, known at this park boundary) instead of speculating
            # on the argmax successor
            target = info.node_id if info.declared else None
            self.prefetcher.maybe_issue(session_id, info.aeg, info.node_id,
                                        entry_bytes, now,
                                        pool.utilization(), target=target,
                                        worker=worker)
        return evicted

    def _insert_ttl_entry(self, session_id: str, worker: int,
                          ctx_tokens: float, entry_bytes: float,
                          tool: str, now: float,
                          node_id: int) -> List[CacheEntry]:
        """Insert/replace a session's pool entry with a tool-aware TTL
        and reconcile every aggregate (bytes total, sites index) — the
        shared tail of ``on_step_end`` and ``preempt_park``, factored so
        the accounting ``check_conservation`` guards lives once."""
        pool = self.pools[worker]
        m = memory_pressure(pool.utilization(), self.cfg.th_low,
                            self.cfg.th_high)
        deadline = None
        if self.cfg.enable_ttl:
            deadline = self.ttl.deadline(tool, now, m)
        entry = CacheEntry(session_id=session_id, size_bytes=entry_bytes,
                           t_last=now, tokens=ctx_tokens,
                           node_id=node_id, ttl_deadline=deadline)
        used_before = pool.used
        evicted = pool.insert(entry, now)
        self.pools_used += pool.used - used_before
        for ev in evicted:
            self._site_discard(ev.session_id, worker)
        if pool.contains(session_id):
            self._site_add(session_id, worker)
        else:            # replaced-but-didn't-fit: old entry is gone too
            self._site_discard(session_id, worker)
        return evicted

    def preempt_park(self, session_id: str, worker: int,
                     ctx_tokens: float, entry_bytes: float,
                     now: float) -> List[CacheEntry]:
        """AFS preemption parked a RUNNING decode mid-step (§6.2): the
        victim's slot KV moves to the pool so a starved session can take
        the slot, and it resumes later with a delta-only prefill.  Like
        ``on_step_end`` this unpins and inserts a TTL-stamped entry, but
        the step is NOT over: the AEG cursor does not advance, tool
        stats see nothing, and no prefetch is speculated (the session
        is going back on the queue, not into a tool gap).  TTL uses the
        tool the session is between — preemption must not demote its
        survival odds below a same-aged tool park (§3.1: predictions
        survive preemption).  Returns evicted entries so the caller can
        free the victims' real blocks."""
        self.unpin(session_id, worker)
        info = self.sessions.get(session_id)
        return self._insert_ttl_entry(
            session_id, worker, ctx_tokens, entry_bytes,
            info.cur_tool if info is not None else "unknown", now,
            info.node_id if info else 0)

    def handoff_land(self, session_id: str, worker: int,
                     ctx_tokens: float, entry_bytes: float,
                     now: float) -> Tuple[bool, List[CacheEntry]]:
        """A prefill→decode KV handoff landed on ``worker`` (disagg
        mode): the staged blocks are now a parked prefix there, so WA-LRU
        must see them.  Inserts a pinned TTL entry — pinned because the
        session is about to resume on this prefix, exactly like a hit's
        ``on_step_start`` pin; ``on_step_end`` unpins as usual.  No
        hit/miss accounting: the step's verdict was counted when the
        prefill job was admitted.  Returns (inserted, evicted) so the
        caller mirrors the real blocks."""
        info = self.sessions.get(session_id)
        evicted = self._insert_ttl_entry(
            session_id, worker, ctx_tokens, entry_bytes,
            info.cur_tool if info is not None else "unknown", now,
            info.node_id if info else 0)
        e = self.pools[worker].entries.get(session_id)
        if e is not None:
            e.pinned = True
        return self.pools[worker].contains(session_id), evicted

    def on_tool_done(self, session_id: str, tool: str, latency_s: float,
                     obs_tokens: float, now: float) -> None:
        self.stats.observe(tool, obs_tokens, latency_s)
        self.ttl.observe(tool, latency_s)

    # -- stealing / migration ------------------------------------------------
    def on_worker_idle(self, worker: int, now: float) -> None:
        """A worker's pending queue just went empty — enter the indexed
        idle set with the *exact* transition time (the legacy per-epoch
        scan quantized idle starts to epoch boundaries).  Prefill-role
        workers never enter the idle set: decode stealers must not raid
        the prefill pool (and a prefill engine has no decode queue to
        accrue steal credit from) — this guard also covers the
        recover/scale-up paths, which re-announce idleness here."""
        if worker in self.prefill_workers:
            return
        if self.cfg.enable_stealing and self.alive[worker]:
            self.stealer.note_queue_state(worker, True, now)

    def on_worker_busy(self, worker: int) -> None:
        """A worker's pending queue just became non-empty — leave the
        idle set (O(1))."""
        if self.cfg.enable_stealing:
            self.stealer.note_queue_state(worker, False, 0.0)

    def epoch_tick(self, now: float, loads: Sequence[float],
                   queues: Sequence[Sequence[Tuple[float, str]]],
                   alive: Optional[Sequence[bool]] = None, *,
                   victim_candidates: Optional[Sequence[int]] = None,
                   scan_queues: bool = True
                   ) -> Tuple[Optional[StealDecision], Dict[str, float]]:
        """Per-epoch AFS share recompute + steal decision.  ``alive``
        defaults to the coordinator's own liveness view; dead workers
        are treated as not-idle (their empty queues must not accrue
        steal credit) and are excluded from thief and victim roles.

        ``scan_queues=True`` (legacy) refreshes the stealer's idle set
        by walking every worker queue.  Callers that report queue-depth
        transitions through ``on_worker_idle``/``on_worker_busy`` (the
        simulator) pass ``scan_queues=False`` plus their nonempty-queue
        index as ``victim_candidates``, making the tick O(changes)
        instead of O(n_workers)."""
        if alive is None:
            alive = self.alive
        shares = self.afs.recompute(now) if self.cfg.enable_afs else {}
        decision = None
        if self.cfg.enable_stealing:
            if scan_queues:
                for w in range(len(loads)):
                    up = w < len(alive) and alive[w]
                    self.stealer.note_queue_state(w, up and not queues[w],
                                                  now)
            decision = self.stealer.maybe_steal(
                now, loads, queues, alive=alive,
                candidates=victim_candidates)
        return decision, shares

    def migrate_session(self, session_id: str, src: int, dst: int,
                        now: float) -> Tuple[float, List[CacheEntry]]:
        """Move a session's cache entry (Llumnix-style).  TTL state moves
        with it (§3.1).  Returns (bytes migrated, entries evicted at the
        destination) — the serving runtime frees the victims' real KV
        blocks from the evicted list."""
        entry = self.pools[src].remove(session_id)
        if entry is None:
            return 0.0, []
        self.pools_used -= entry.size_bytes
        self._site_discard(session_id, src)
        entry.t_last = now
        dst_pool = self.pools[dst]
        used_before = dst_pool.used
        evicted = dst_pool.insert(entry, now)
        self.pools_used += dst_pool.used - used_before
        for ev in evicted:
            self._site_discard(ev.session_id, dst)
        if dst_pool.contains(session_id):
            self._site_add(session_id, dst)
        self.router.set_home(session_id, dst)
        return entry.size_bytes, evicted

    # -- fault tolerance -------------------------------------------------
    def worker_failed(self, worker: int) -> List[str]:
        """Worker dies: cache lost (pool wiped, so any pinned hit
        entries go with it), affinities dropped, liveness flag cleared
        — routing/stealing consult it from here on.  Sessions re-route
        on their next step and pay cache-loss regeneration (§3.1); the
        simulator pairs this with cancelling the worker's in-flight
        steps and requeueing them on live workers.  Returns the session
        ids whose state was lost."""
        if not self.alive[worker]:
            return []
        self.alive[worker] = False
        self._n_dead += 1
        if np is not None:
            self._alive_np[worker] = False
        pool = self.pools[worker]
        lost = list(pool.entries)
        self.pools_used -= pool.used
        for sid in lost:
            self._site_discard(sid, worker)
        self.pools[worker] = self._make_pool()
        dropped = self.router.evict_worker(worker)
        # NOTE: in-flight prefetch jobs are NOT cancelled here — on the
        # simulator they model background regenerations that run wherever
        # the next step lands, so they survive the source's death.  The
        # serving runtime, whose jobs are real block copies sourced from
        # the dead engine, calls ``prefetcher.cancel_worker`` itself.
        # dead workers leave the indexed idle set: an empty queue on a
        # corpse must not accrue steal credit
        self.stealer.note_queue_state(worker, False, 0.0)
        return sorted(set(lost) | set(dropped))

    def worker_recovered(self, worker: int, now: float = 0.0) -> None:
        if self.alive[worker]:
            return
        self.alive[worker] = True
        self._n_dead -= 1
        if np is not None:
            self._alive_np[worker] = True
        # a recovered worker comes back with an empty queue: idle now
        self.on_worker_idle(worker, now)

    def add_worker(self, now: float = 0.0) -> int:
        self.pools.append(self._make_pool())
        self.alive.append(True)
        if np is not None:
            self._alive_np = np.append(self._alive_np, True)
        self.n_workers += 1
        self.on_worker_idle(self.n_workers - 1, now)
        return self.n_workers - 1

    # -- checkpoint/restart ------------------------------------------------
    @staticmethod
    def _session_snap(v: SessionInfo) -> dict:
        snap = {
            "tenant": v.tenant, "node_id": v.node_id,
            "ctx_tokens": v.ctx_tokens, "cur_tool": v.cur_tool,
            "tools_seen": list(v.tools_seen),
            "prefix_tokens": v.prefix_tokens,
            "declared": v.declared, "step_cost_s": v.step_cost_s,
        }
        if v.declared and v.aeg is not None:
            # the declared graph must survive restarts: Eq. 9 set_work
            # and prefetch targeting run on it after restore
            snap["aeg_nodes"] = {int(nid): n.tool
                                 for nid, n in v.aeg.nodes.items()}
            snap["aeg_edges"] = [(int(nid), int(u), float(p))
                                 for nid, n in v.aeg.nodes.items()
                                 for u, p in n.succs]
            snap["aeg_p_term"] = v.aeg.p_term
        return snap

    def snapshot(self) -> dict:
        return {
            "cfg": asdict(self.cfg),
            "router_home": dict(self.router.home),
            "sessions": {k: self._session_snap(v)
                         for k, v in self.sessions.items()},
            "ttl_hist": {k: list(v) for k, v in self.ttl.hist.items()},
            "inferencer_counts": {a: dict(b) for a, b in
                                  self.inferencer.counts.items()},
            "inferencer_n": self.inferencer.n_tasks,
            "alive": list(self.alive),
        }

    def restore(self, snap: dict) -> None:
        self.router.home = dict(snap["router_home"])
        for k, sv in snap["sessions"].items():
            info = SessionInfo(k, sv["tenant"], None, sv["node_id"],
                               sv["ctx_tokens"], sv["cur_tool"],
                               list(sv["tools_seen"]), sv["prefix_tokens"],
                               declared=sv.get("declared", False),
                               step_cost_s=sv.get("step_cost_s", 0.0))
            if info.declared and sv.get("aeg_nodes"):
                # rebuild the declared graph exactly (int() for snapshots
                # that round-tripped through JSON string keys)
                tools = {int(n): t for n, t in sv["aeg_nodes"].items()}
                edges = [(int(u), int(w), float(p))
                         for u, w, p in sv["aeg_edges"]]
                info.aeg = AEG.from_edges(
                    tools, edges, p_term=sv.get("aeg_p_term", 0.03))
            elif self.cfg.observability == "hints":
                info.declared = False      # graph lost: fall back to
                info.aeg = AEG.linear_chain(   # linear-chain hints
                    info.tools_seen[-1:] * 4 or ["unknown"])
            self.sessions[k] = info
        self.ttl.hist = {k: list(v) for k, v in snap["ttl_hist"].items()}
        for a, b in snap["inferencer_counts"].items():
            for c, n in b.items():
                self.inferencer.counts[a][c] = n
        self.inferencer.n_tasks = snap["inferencer_n"]
        self.alive = list(snap["alive"])
        # resync the liveness mirrors the numpy route() fast path and
        # the fail/recover transition counters depend on
        self._n_dead = sum(1 for a in self.alive if not a)
        if np is not None:
            self._alive_np = np.array(self.alive, dtype=bool)

"""Single-worker serving engine: continuous batching over decode slots +
paged KV living in pool blocks from admit to finish.

The twin of ``repro.serving.engine`` on PyTorch.  In the default
**paged** mode a session's KV lands in ``PagedKVPool`` blocks at admit
(prefill scatters straight into blocks), the batched decode step attends
over per-slot block tables and appends each new token's K/V into the tail
block on device, and park/resume/preempt are pure metadata flips — zero
device copies.  ``Engine(paged=False)`` is the reference's gather oracle:
contiguous per-slot caches (``lm.init_cache``), park/resume as real
pool<->slot copies.  The engine's tensors live on the params' device: on
the card, prefill runs the flash kernel and each decode round the append
and paged-attention kernels (gather mode reads each slot's cache as one
block); on the CPU, their plain versions.

PyTorch runs eagerly, so there is no jit cache; the prefill lengths are
still padded to the reference's lcm quantum, which keeps the KV (and the
token ids) the reference's.

``Engine(env=...)`` with a mesh runs on each rank of it, as the
reference's engine jits its functions with ``env``: the params are
DTensors (``lm.param_shardings``), the prefill and the decode steps are
``lm``'s sharded ones, the paged pool is laid out as
``kvcache.pool_sharding`` puts it (every data replica holds every block;
``lm.decode_step_paged`` says why), and the gather mode's slot caches as
``lm.cache_pspecs``.  The prefill's cache (its sequence over 'model') is
gathered before it lands in blocks or slots, and the greedy pick is
taken from the gathered logits, so every rank picks the same id and
keeps the same host state (slots, tables, free list, counters, copy
bytes).  The MoE archs run ``env.opts["moe_impl"]``, as the reference's
engine does.  With ``env`` None the engine runs on one device.

``Engine.wall``, a ``repro_torch.obs.tracer.Tracer`` the caller sets (None
by default), records wall-clock spans on the clock ``torch.profiler``
stamps its events with (``wall_clock``), so they lie over a device trace:
``admit`` (children ``admit.prefill``, ``admit.land``, ``admit.wait``) per
``start_session`` and ``round`` (children ``round.prep``, ``round.model``,
``round.wait``, ``round.commit`` per step) per ``decode``.  With it None
the engine reads no clock and records nothing.  The spans only record:
nothing the engine or the runtime decides reads them.

A paged engine on one CUDA device (``env`` None) replays each round's
model body, ``lm.decode_body_paged``, as one CUDA graph
(``serving/round_graph.py``), captured at its first paged decode; the
unembed and the argmax stay eager.  The engine observes the three facts
itself: gather mode, a mesh and the CPU run the eager round.
``graph_captures`` counts the captures (one per engine) and
``graph_rounds`` the steps served by a replay; with the graph
``round.model`` holds the inputs' one copy to the device, the replay and
the unembed's enqueue, and ``round.wait`` the device's time (the
``round`` span's ``graph`` meta says which round ran).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.layers import on_mesh
from repro_torch.obs.tracer import Tracer
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.round_graph import RoundGraph

# the reference's jit bucket: prefill lengths pad to lcm(bucket,
# block_size) so a bucket boundary never splits a KV block
# (PagedKVPool.extend asserts this invariant)
_PREFILL_BUCKET = 32

# the wall spans' one track, and the children of an admission (after its
# bookkeeping) and of a decode step (tiling it), in order
WALL_TRACK = "engine"
ADMIT_PHASES = ("admit.prefill", "admit.land", "admit.wait")
ROUND_PHASES = ("round.prep", "round.model", "round.wait", "round.commit")


def wall_clock() -> float:
    """Seconds on the clock ``torch.profiler`` stamps its events with: a
    kineto event's ``start_ns()`` lies between two reads of
    ``time.time_ns()`` (``tests/test_torch_engine_spans.py`` pins it on the
    CPU, ``tests/test_torch_cuda.py`` against the card's events)."""
    # sagalint: ok(det-clock) wall spans only record, never feed a decision
    return time.time_ns() / 1e9


def _mark(t: Optional[List[float]]) -> None:
    """Append the wall clock to ``t``, a traced call's marks; None (the
    engine's ``wall`` off) reads no clock."""
    if t is not None:
        t.append(wall_clock())


def check_engine_family(cfg: ModelConfig) -> None:
    """The families the engine serves, those of the reference's engine
    (``repro/serving/engine.py:103-106``): the decoder-only families with
    a GQA (k, v) cache, dense, moe and vlm.  ssm, hybrid, enc-dec and MLA
    raise ``ValueError`` where the reference asserts."""
    if cfg.enc_dec or cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name} ({cfg.family}): the engine serves "
                         f"decoder-only GQA KV families, as the reference "
                         f"engine does")
    if cfg.use_mla:
        raise ValueError(f"{cfg.name}: the engine's KV paths assume the GQA "
                         f"(k, v) cache layout, as the reference engine's "
                         f"do")


def uses_round_graph(device: torch.device, paged: bool, env) -> bool:
    """Whether an engine replays its decode rounds as a CUDA graph
    (``serving/round_graph.py``): paged, on a CUDA device, with no
    ``env``."""
    return paged and device.type == "cuda" and env is None


@dataclasses.dataclass
class SlotState:
    session_id: Optional[str] = None
    length: int = 0                 # tokens currently cached for the slot


class Engine:
    """Decode slots + prefill + park/resume for one worker."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_len: int = 512, pool_blocks: int = 64,
                 block_size: int = 16, env=None, paged: bool = True):
        check_engine_family(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.env = env
        self.mesh = on_mesh(env)
        self.n_slots = n_slots
        self.max_len = max_len
        self.paged = paged
        self.slots = [SlotState() for _ in range(n_slots)]
        if paged:
            assert max_len % block_size == 0, \
                "paged decode needs max_len to be a whole number of blocks"
            self.max_nb = max_len // block_size
            # resident headroom: every slot can hold a max_len session in
            # blocks without ever competing with the parked population,
            # so policy-visible capacity stays identical to gather mode
            headroom = n_slots * self.max_nb
            self.cache = None
        else:
            self.max_nb = 0
            headroom = 0
            self.cache = lm.init_cache(cfg, n_slots, max_len,
                                       device=self.device)
            if self.mesh:
                from repro_torch.models.sharding import distribute
                self.cache = distribute(self.cache, lm.cache_pspecs(
                    cfg, env, n_slots, max_len))
        self.pool = PagedKVPool(cfg.n_layers, pool_blocks, block_size,
                                cfg.n_kv_heads, cfg.head_dim,
                                headroom_blocks=headroom,
                                device=self.device, env=env)
        # prefill quantum: a whole number of blocks AND of the base
        # bucket, so a bucket boundary never splits a tail block
        self._prefill_quantum = (_PREFILL_BUCKET * block_size
                                 // math.gcd(_PREFILL_BUCKET, block_size))
        # stats
        self.prefill_tokens = 0
        # every admission that prefilled its whole context, first
        # admissions included: rt.stats() sums it and the serving
        # fingerprints read it (the ``admit`` spans' kinds tell resumes)
        self.regen_tokens = 0
        self.decode_steps = 0
        # device-copy accounting for the park/resume/migration paths
        # (paged mode: park/resume are metadata-only and stay 0)
        self.park_copy_bytes = 0
        self.resume_copy_bytes = 0
        self.migration_copy_bytes = 0
        # prefill->decode handoff transport (disaggregated pools):
        # counted separately from migration so the A/B stays legible
        self.handoff_copy_bytes = 0
        # wall-clock spans (the ``wall`` property)
        self._wall: Optional[Tracer] = None
        self._wall_seen: Optional[Set[str]] = None
        # the round's CUDA graph, made at the first paged decode where
        # ``uses_round_graph``; its counters stay out of rt.stats()
        self._graph: Optional[RoundGraph] = None
        self.graph_captures = 0
        self.graph_rounds = 0

    @property
    def wall(self) -> Optional[Tracer]:
        """The wall-clock span recorder, or None (no clock read, nothing
        recorded).  The ids of the sessions admitted while it is set live
        from its first setting until it is set to None, so a tracer
        swapped for another keeps telling a first admission from a
        resume, and tracing off holds no per-session state."""
        return self._wall

    @wall.setter
    def wall(self, tracer: Optional[Tracer]) -> None:
        if tracer is None:
            self._wall_seen = None
        elif self._wall is None:
            self._wall_seen = set()
        self._wall = tracer

    def _ints(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    def _whole(self, t) -> torch.Tensor:
        """A model output whole on this rank: a DTensor gathered (with no
        mesh, ``t`` itself)."""
        if not self.mesh:
            return t
        return self.env.cs(t, *[None] * t.dim()).to_local()

    # -- slot management -----------------------------------------------------
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.session_id is None:
                return i
        return None

    def used_slots(self) -> int:
        """Occupied decode slots (ground truth for load reporting and
        the runtime's conservation checks)."""
        return sum(1 for s in self.slots if s.session_id is not None)

    def _write_slot(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                    length: int) -> None:
        """k/v: (L, S, K, dh) -> into the batched decode cache, the rest of
        the slot's row zeroed (the reference pads to max_len)."""
        n = k.shape[1]
        for cache, new in ((self.cache["k"], k), (self.cache["v"], v)):
            if self.mesh:
                _write_row(cache, slot, new)
                continue
            cache[:, slot, :n] = new
            cache[:, slot, n:] = 0
        self.slots[slot].length = length

    def _pad_len(self, n: int) -> int:
        """The length a prefill of ``n`` tokens runs at: ``n`` up to the
        prefill quantum, at most ``max_len`` (and never below ``n``)."""
        q = self._prefill_quantum
        return max(n, min(self.max_len, -(-n // q) * q))

    def _prefill_kv(self, tokens: np.ndarray):
        """Prefill ``tokens`` and return (k, v) of shape (L, n, K, dh).

        Token length is padded up to the reference's compile quantum —
        lcm(32-token bucket, block size) — so a bucket boundary never
        splits a KV block.  Padding is exact under the causal mask:
        positions < n attend to the same key set either way.  A vlm
        serves text only: its patch stream is empty (1, 0, d_model), as
        in the reference, which is exact, not an approximation."""
        n = len(tokens)
        pad_to = self._pad_len(n)
        padded = np.zeros(pad_to, np.int32)
        padded[:n] = tokens
        batch = {"tokens": self._ints(padded[None], torch.long)}
        if self.cfg.family == "vlm":
            batch["patches"] = torch.zeros(1, 0, self.cfg.d_model,
                                           dtype=torch.bfloat16,
                                           device=self.device)
        _, cache = lm.prefill(self.params, batch, self.cfg, self.env,
                              max_len=pad_to)
        return (self._whole(cache["k"])[:, 0, :n],
                self._whole(cache["v"])[:, 0, :n])

    # -- public API ------------------------------------------------------------
    def start_session(self, sid: str, tokens: np.ndarray,
                      cached_hit: bool) -> Optional[int]:
        """Admit a session: resume parked KV if present (prefill only the
        delta) else full prefill.  Returns the slot id, or ``None`` when
        every slot is occupied — the caller (the serving runtime) queues
        the session instead of crashing."""
        slot = self.free_slot()
        if slot is None:
            return None
        tokens = np.asarray(tokens, np.int32)
        t = [wall_clock()] if self._wall is not None else None
        hit, n, parked = self._take(sid, cached_hit)
        todo = tokens[n:]
        _mark(t)
        kv = self._prefill_kv(todo) if len(todo) or not hit else None
        _mark(t)
        self._land(slot, sid, tokens, hit, n, parked, kv)
        _mark(t)
        if t is not None:
            # admit.wait: the span holds the prefill's device time
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t.append(wall_clock())
            self._admit_spans(t, slot, sid, len(tokens), hit,
                              len(todo) if kv is not None else 0)
        return slot

    def _admit_spans(self, t: List[float], slot: int, sid: str, ctx: int,
                     hit: bool, prefill: int) -> None:
        """An admission's ``admit`` span and its children from the marks
        ``t`` (its start, then the ends of its bookkeeping and of each
        child); its kind is ``hit``, else ``regen`` for a session admitted
        while ``wall`` was set, else ``first``."""
        seen = self._wall_seen
        kind = "hit" if hit else "regen" if sid in seen else "first"
        seen.add(sid)
        w, track = self._wall, WALL_TRACK
        aid = w.complete(track, "admit", t[0], t[-1], sid=sid, kind=kind,
                         ctx=ctx, prefill=prefill,
                         padded=self._pad_len(prefill) if prefill else 0,
                         slot=slot)
        for name, a, b in zip(ADMIT_PHASES, t[1:], t[2:]):
            w.complete(track, name, a, b, parent=aid)

    def _take(self, sid: str, cached_hit: bool):
        """An admission's bookkeeping before its prefill: (hit, tokens
        whose KV the engine already holds, the parked KV copied out in
        gather mode or None)."""
        if self.paged:
            return self._take_paged(sid, cached_hit)
        return self._take_gather(sid, cached_hit)

    def _take_paged(self, sid: str, cached_hit: bool):
        """A cached hit is a pure metadata flip (parked -> resident); a
        miss allocates at admit.  The delta is then prefilled alone,
        positions counted from 0, as in the reference, and scattered
        straight into blocks.  Resume-copy bytes stay 0."""
        pool = self.pool
        if cached_hit and pool.has(sid):
            n = pool.lens[sid]
            pool.mark_resident(sid)
            return True, n, None
        pool.alloc(sid)
        return False, 0, None

    def _take_gather(self, sid: str, cached_hit: bool):
        """Gather mode: a hit copies the parked blocks out (an
        O(context-bytes) resume copy) and frees them."""
        resumed = self.pool.resume(sid) if cached_hit else None
        if resumed is None:
            return False, 0, None
        k, v, n = resumed
        self.resume_copy_bytes += self.pool.session_bytes(sid)
        self.pool.free_session(sid)
        return True, n, (k, v)

    def _land(self, slot: int, sid: str, tokens: np.ndarray, hit: bool,
              n: int, parked, kv) -> None:
        """Land the prefilled KV ``kv`` (or None) in the session's pool
        blocks, or with the parked KV in the slot's contiguous cache in
        gather mode; bind the slot and count."""
        if self.paged:
            if kv is not None:
                self.pool.extend(sid, *kv, bucket=self._prefill_quantum)
            self.slots[slot] = SlotState(sid, len(tokens))
        else:
            k, v = kv if parked is None else parked
            if parked is not None and kv is not None:
                k = torch.cat([k, kv[0]], dim=1)
                v = torch.cat([v, kv[1]], dim=1)
            self._write_slot(slot, k, v, len(tokens))
            self.slots[slot].session_id = sid
        if kv is not None:
            self.prefill_tokens += len(tokens) - n
        if not hit:
            self.regen_tokens += len(tokens)

    def decode(self, slot_tokens: Dict[int, int],
               n_steps: int = 1) -> Dict[int, List[int]]:
        """Run ``n_steps`` batched greedy decode steps for the given
        slots.  slot_tokens: {slot: next input token id}.  Returns
        generated ids per slot; the argmax runs on the device and the ids
        come back once per step.

        Paged mode attends over pool block tables and appends each new
        K/V into the tail block on device; idle batch rows carry an
        out-of-range append sentinel so they write nowhere.  Gather mode
        runs ``lm.decode_step`` over the slot caches, where, as in the
        reference, an idle row decodes token 0 at position 0 and writes
        its K/V there, into an occupied slot too (so a slot that sits a
        round out loses its first cached token)."""
        out: Dict[int, List[int]] = {s: [] for s in slot_tokens}
        cur = dict(slot_tokens)
        t = [wall_clock()] if self._wall is not None else None
        for _ in range(n_steps):
            inputs = self._round_inputs(cur)
            _mark(t)
            logits = self._round_model(inputs)
            _mark(t)
            nxt = self._round_ids(logits)
            _mark(t)
            self._round_commit(cur, out, nxt)
            _mark(t)
        if t is not None:
            # visible: the live rows' positions + 1 at the round's start
            visible = sum(self.slots[s].length + 1 - n_steps for s in cur)
            w, track = self._wall, WALL_TRACK
            rid = w.complete(track, "round", t[0], t[-1], rows=len(cur),
                             n_steps=n_steps, visible=visible,
                             graph=self._graph is not None)
            for i in range(len(t) - 1):
                w.complete(track, ROUND_PHASES[i % 4], t[i], t[i + 1],
                           parent=rid)
        return out

    def _round_inputs(self, cur: Dict[int, int]) -> Tuple:
        """A step's inputs on the device: the rows' tokens and positions
        and, in paged mode, the block tables (with tail room ensured) and
        each row's append block and offset.  Where the round graph runs
        they are written into its staging buffer's host arrays instead,
        which ``_round_model`` copies over."""
        if not self.paged:
            tok = np.zeros((self.n_slots, 1), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            for s, t in cur.items():
                tok[s, 0] = t
                pos[s] = self.slots[s].length
            return self._ints(tok, torch.long), self._ints(pos)
        graph = self._round_graph()
        if graph is not None:
            return self._paged_arrays(cur, graph.inputs.arrays)
        tok, tables, pos, ablk, aoff = self._paged_arrays(cur)
        return (self._ints(tok, torch.long), self._ints(tables),
                self._ints(pos), self._ints(ablk), self._ints(aoff))

    def _paged_arrays(self, cur: Dict[int, int], out=None):
        """A paged step's five inputs as host arrays, written into ``out``
        (a ``StagedInputs``' arrays) where given: tokens (n_slots, 1),
        block tables (n_slots, max_nb) with tail room ensured, positions,
        append blocks (the drop sentinel on idle rows) and offsets."""
        pool = self.pool
        if out is None:
            n = self.n_slots
            out = (np.empty((n, 1), np.int64),
                   np.empty((n, self.max_nb), np.int32),
                   *(np.empty(n, np.int32) for _ in range(3)))
        tok, tables, pos, ablk, aoff = out
        for a in (tok, tables, pos, aoff):
            a.fill(0)
        ablk.fill(pool.total_blocks)
        for s, t in cur.items():
            sid = self.slots[s].session_id
            tok[s, 0] = t
            pos[s] = self.slots[s].length
            pool.ensure_tail_room(sid)
            tbl = pool.tables[sid]
            tables[s, :len(tbl)] = tbl
            ablk[s], aoff[s] = pool.tail_slot(sid)
        return out

    def _round_graph(self) -> Optional[RoundGraph]:
        """The round graph where ``uses_round_graph``, captured at the
        first call; else None."""
        if self._graph is None and uses_round_graph(self.device, self.paged,
                                                    self.env):
            self._graph = RoundGraph(self.params, self.cfg,
                                     self.pool.k_pool, self.pool.v_pool,
                                     self.n_slots, self.max_nb,
                                     self.pool.total_blocks)
            self.graph_captures += 1
        return self._graph

    def _round_model(self, inputs: Tuple) -> torch.Tensor:
        """One decode step of the model; returns the logits (n_slots, 1,
        V).  With the round graph: the staged inputs copied over, the
        body replayed, then the unembed."""
        if not self.paged:
            tok, pos = inputs
            logits, self.cache = lm.decode_step(
                self.params, tok, self.cache, pos, self.cfg, self.env)
            return logits
        if self._graph is not None:
            self.graph_rounds += 1
            return lm.unembed(self.params, self._graph.replay(), self.cfg)
        pool = self.pool
        tok, tables, pos, ablk, aoff = inputs
        logits, pool.k_pool, pool.v_pool = lm.decode_step_paged(
            self.params, tok, pool.k_pool, pool.v_pool, tables, pos, ablk,
            aoff, self.cfg, self.env)
        return logits

    def _round_ids(self, logits: torch.Tensor) -> np.ndarray:
        """The greedy ids, picked on the device; the host waits for them
        here."""
        return self._whole(logits)[:, 0, :].argmax(dim=-1).cpu().numpy()

    def _round_commit(self, cur: Dict[int, int], out: Dict[int, List[int]],
                      nxt: np.ndarray) -> None:
        """Each row's new token: its pool length, its slot's length, the
        output and the next step's input."""
        for s in cur:
            if self.paged:
                self.pool.append_token(self.slots[s].session_id)
            self.slots[s].length += 1
            out[s].append(int(nxt[s]))
            cur[s] = int(nxt[s])
        self.decode_steps += 1

    def park_session(self, sid: str) -> bool:
        """Session pauses for a tool call.  Paged mode: metadata-only —
        the blocks already live in the pool, parking just flips the
        session from resident to parked accounting (on False the slot
        keeps its binding so ``release_session`` still frees the
        blocks).  Gather mode: copy the slot KV into pool blocks."""
        slot = next((i for i, s in enumerate(self.slots)
                     if s.session_id == sid), None)
        if slot is None:
            return False
        if self.paged:
            if not self.pool.park_resident(sid):
                return False
            self.slots[slot] = SlotState()
            return True
        ok = self.pool.park(sid, self._whole(self.cache["k"])[:, slot],
                            self._whole(self.cache["v"])[:, slot],
                            self.slots[slot].length)
        if ok:
            self.park_copy_bytes += self.pool.session_bytes(sid)
        self.slots[slot] = SlotState()
        return ok

    def release_session(self, sid: str) -> bool:
        """Free a session's slot WITHOUT parking its KV (task finished:
        nothing will resume).  In paged mode this returns the resident
        blocks to the free list — still metadata-only."""
        slot = next((i for i, s in enumerate(self.slots)
                     if s.session_id == sid), None)
        if slot is None:
            return False
        if self.paged and sid in self.pool.resident:
            self.pool.free_session(sid)
        self.slots[slot] = SlotState()
        return True

    # -- KV export/import (cross-engine migration + prefetch copies) --------
    def export_kv(self, sid: str) -> Optional[Tuple[torch.Tensor,
                                                    torch.Tensor, int]]:
        """Copy a parked session's KV to contiguous (L, n, K, dh)
        WITHOUT freeing its blocks — the transport half of a pool-to-pool
        copy (work-steal migration, speculative prefetch).  Only the
        owned blocks are copied."""
        return self.pool.resume(sid)

    def import_kv(self, sid: str, k: torch.Tensor, v: torch.Tensor,
                  n_tokens: int) -> bool:
        """Land an exported KV prefix into this engine's pool.  Returns
        False when the pool has no room (caller evicts and retries, or
        abandons the copy)."""
        ok = self.pool.park(sid, k, v, n_tokens)
        if ok:
            self.migration_copy_bytes += self.pool.session_bytes(sid)
        return ok

    # -- disaggregated prefill/decode handoff (serving/disagg.py) -----------
    def stage_prefill(self, sid: str, tokens: np.ndarray,
                      start: int) -> bool:
        """Prefill-role engines: compute KV for ``tokens[start:]``
        standalone (the same delta prefill a resume runs) and stage it in
        this pool as a PARKED session awaiting handoff.  ``start == 0``
        is a miss: the full context is regenerated here.  Returns False
        when the staging pool cannot fit."""
        delta = np.asarray(tokens[start:], np.int32)
        dk, dv = self._prefill_kv(delta)
        if not self.pool.park(sid, dk, dv, len(delta)):
            return False
        self.prefill_tokens += len(delta)
        if start == 0:
            self.regen_tokens += len(delta)
        return True

    def import_handoff(self, sid: str, k: torch.Tensor, v: torch.Tensor,
                       n_tokens: int, *, append: bool) -> bool:
        """Decode-role engines: land handed-off prefill KV.  ``append``
        (cache hit) extends the parked prefix in place; otherwise (miss)
        the full context parks fresh.  Returns False when the parked
        population would overflow nominal capacity."""
        if append:
            ok = self.pool.extend_parked(sid, k, v, n_tokens)
        else:
            ok = self.pool.park(sid, k, v, n_tokens)
        if ok:
            self.handoff_copy_bytes += int(n_tokens) * \
                (self.pool.bytes_per_block // self.pool.block)
        return ok

    def evict_session(self, sid: str) -> None:
        """Policy eviction of parked blocks.  A resident session's
        blocks are pinned by its slot (mirroring gather mode, where a
        resumed session holds no pool blocks at all): no-op until the
        slot releases them."""
        if self.paged and sid in self.pool.resident:
            return
        self.pool.free_session(sid)

    def fail(self) -> List[str]:
        """Engine crash: every decode slot and every parked session is
        lost at once.  Clears the slot table and the block tables (the
        device tensors stay allocated — new sessions overwrite them, and
        an empty slot/table means no decode or resume can read stale
        KV).  Returns the session ids whose state was held here, sorted,
        so the runtime can cancel their in-flight attempts."""
        lost = {s.session_id for s in self.slots
                if s.session_id is not None}
        lost.update(self.pool.tables)
        self.slots = [SlotState() for _ in range(self.n_slots)]
        for sid in list(self.pool.tables):
            self.pool.free_session(sid)
        return sorted(lost)

    def has_cache(self, sid: str) -> bool:
        return self.pool.has(sid)

    def pool_used_fraction(self) -> float:
        return self.pool.used_blocks() / self.pool.num_blocks


def _write_row(cache, slot: int, new) -> None:
    """Write slot ``slot``'s row of a sharded slot cache (L, n_slots,
    max_len, K, dh): ``new`` (L, n, K, dh), whole on every rank, then
    zeros, each rank writing the positions of its shard where it holds the
    slot's row."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    if not off[1] <= slot < off[1] + shape[1]:
        return
    row = new.new_zeros((cache.shape[0], cache.shape[2], *cache.shape[3:]))
    row[:, :new.shape[1]] = new
    cache.to_local()[:, slot - off[1]] = \
        row[:, off[2]:off[2] + shape[2], off[3]:off[3] + shape[3]]

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving.kvcache import PagedKVPool

# the reference's jit bucket: prefill lengths pad to lcm(bucket,
# block_size) so a bucket boundary never splits a KV block
# (PagedKVPool.extend asserts this invariant)
_PREFILL_BUCKET = 32


def check_engine_family(cfg: ModelConfig) -> None:
    """The families the engine serves.  Like the reference's engine
    (``repro/serving/engine.py:103``) it refuses what has no GQA (k, v)
    cache: ssm, hybrid, enc-dec and MLA.  Of the decoder-only KV families
    the port serves dense; moe and vlm come in a later slice."""
    if cfg.enc_dec or cfg.family not in ("dense", "moe", "vlm") \
            or cfg.use_mla:
        raise ValueError(f"{cfg.name} ({cfg.family}): the engine serves "
                         f"decoder-only GQA KV families, as the reference "
                         f"engine does")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): the port's "
                                  f"engine serves the dense family; moe and "
                                  f"vlm come in a later slice")


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
        self.env = env              # kept for the runtime's scale-up call
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
        self.pool = PagedKVPool(cfg.n_layers, pool_blocks, block_size,
                                cfg.n_kv_heads, cfg.head_dim,
                                headroom_blocks=headroom,
                                device=self.device)
        # prefill quantum: a whole number of blocks AND of the base
        # bucket, so a bucket boundary never splits a tail block
        self._prefill_quantum = (_PREFILL_BUCKET * block_size
                                 // math.gcd(_PREFILL_BUCKET, block_size))
        # stats
        self.prefill_tokens = 0
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

    def _ints(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

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
            cache[:, slot, :n] = new
            cache[:, slot, n:] = 0
        self.slots[slot].length = length

    def _prefill_kv(self, tokens: np.ndarray):
        """Prefill ``tokens`` and return (k, v) of shape (L, n, K, dh).

        Token length is padded up to the reference's compile quantum —
        lcm(32-token bucket, block size) — so a bucket boundary never
        splits a KV block.  Padding is exact under the causal mask:
        positions < n attend to the same key set either way."""
        n = len(tokens)
        pad_to = min(self.max_len, -(-n // self._prefill_quantum)
                     * self._prefill_quantum)
        pad_to = max(pad_to, n)
        padded = np.zeros(pad_to, np.int32)
        padded[:n] = tokens
        _, cache = lm.prefill(
            self.params, {"tokens": self._ints(padded[None], torch.long)},
            self.cfg, max_len=pad_to)
        return cache["k"][:, 0, :n], cache["v"][:, 0, :n]

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
        if self.paged:
            self._admit_paged(sid, tokens, cached_hit)
            self.slots[slot] = SlotState(sid, len(tokens))
        else:
            self._admit_gather(slot, sid, tokens, cached_hit)
            self.slots[slot].session_id = sid
        return slot

    def _admit_paged(self, sid: str, tokens: np.ndarray,
                     cached_hit: bool) -> None:
        """Land the session's KV in pool blocks.  A cached hit is a pure
        metadata flip (parked -> resident) plus a delta prefill scattered
        straight into blocks; a miss allocates at admit and prefills the
        full context into blocks.  As in the reference, the delta is
        prefilled alone, positions counted from 0.  Resume-copy bytes
        stay 0."""
        pool = self.pool
        if cached_hit and pool.has(sid):
            n = pool.lens[sid]
            pool.mark_resident(sid)
            delta = tokens[n:]
            if len(delta):
                dk, dv = self._prefill_kv(delta)
                pool.extend(sid, dk, dv, bucket=self._prefill_quantum)
                self.prefill_tokens += len(delta)
        else:
            pool.alloc(sid)
            k, v = self._prefill_kv(tokens)
            pool.extend(sid, k, v, bucket=self._prefill_quantum)
            self.prefill_tokens += len(tokens)
            self.regen_tokens += len(tokens)

    def _admit_gather(self, slot: int, sid: str, tokens: np.ndarray,
                      cached_hit: bool) -> None:
        """Gather mode: copy parked blocks into the contiguous per-slot
        cache (an O(context-bytes) resume copy)."""
        resumed = self.pool.resume(sid) if cached_hit else None
        if resumed is not None:
            k, v, n = resumed
            self.resume_copy_bytes += self.pool.session_bytes(sid)
            delta = tokens[n:]
            self.pool.free_session(sid)
            if len(delta):
                dk, dv = self._prefill_kv(delta)
                k = torch.cat([k, dk], dim=1)
                v = torch.cat([v, dv], dim=1)
                self.prefill_tokens += len(delta)
            self._write_slot(slot, k, v, len(tokens))
        else:
            k, v = self._prefill_kv(tokens)
            self.prefill_tokens += len(tokens)
            self.regen_tokens += len(tokens)
            self._write_slot(slot, k, v, len(tokens))

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
        for _ in range(n_steps):
            tok = np.zeros((self.n_slots, 1), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            for s, t in cur.items():
                tok[s, 0] = t
                pos[s] = self.slots[s].length
            if self.paged:
                logits = self._step_paged(cur, tok, pos)
            else:
                logits, self.cache = lm.decode_step(
                    self.params, self._ints(tok, torch.long), self.cache,
                    self._ints(pos), self.cfg)
            nxt = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
            for s in cur:
                if self.paged:
                    self.pool.append_token(self.slots[s].session_id)
                self.slots[s].length += 1
                out[s].append(int(nxt[s]))
                cur[s] = int(nxt[s])
            self.decode_steps += 1
        return out

    def _step_paged(self, cur: Dict[int, int], tok: np.ndarray,
                    pos: np.ndarray) -> torch.Tensor:
        """One paged decode step for the rows in ``cur``; returns the
        logits (n_slots, 1, V)."""
        pool = self.pool
        tables = np.zeros((self.n_slots, self.max_nb), np.int32)
        ablk = np.full((self.n_slots,), pool.total_blocks, np.int32)
        aoff = np.zeros((self.n_slots,), np.int32)
        for s in cur:
            sid = self.slots[s].session_id
            pool.ensure_tail_room(sid)
            tbl = pool.tables[sid]
            tables[s, :len(tbl)] = tbl
            ablk[s], aoff[s] = pool.tail_slot(sid)
        logits, pool.k_pool, pool.v_pool = lm.decode_step_paged(
            self.params, self._ints(tok, torch.long), pool.k_pool,
            pool.v_pool, self._ints(tables), self._ints(pos),
            self._ints(ablk), self._ints(aoff), self.cfg)
        return logits

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
        ok = self.pool.park(sid, self.cache["k"][:, slot],
                            self.cache["v"][:, slot],
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

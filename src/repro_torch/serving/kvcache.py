"""Paged KV cache pool (vLLM's PagedAttention) on PyTorch device tensors.

The twin of ``repro.serving.kvcache``.  The pool is a pair of device
tensors
    k_pool, v_pool: (L, total_blocks, block_size, K, dh)
plus host-side block tables {session -> [block ids]}.  Eviction and TTL
never touch device memory — they only mutate the table + free list,
exactly like the paper's WA-LRU over PagedAttention blocks.

Two session populations share the arrays:

  * **parked** sessions (the classic population): idle KV held across
    tool calls, counted against the *nominal* capacity ``num_blocks``
    that the coordinator's WA-LRU/TTL policy budgets against.
  * **resident** sessions (paged decode): slot-bound sessions whose KV
    lives in blocks from admit to finish.  Their blocks ride in the
    ``headroom_blocks`` the engine sizes for its slots
    (n_slots * max_len/block), so they never compete with the parked
    population — policy-visible capacity checks (``can_fit``,
    ``park_resident``) see exactly the same arithmetic as a
    gather-mode pool, which keeps paged and gather scheduling
    decisions bit-identical.

Parking a resident session is metadata-only (a set flip, no copy); so
is resuming a parked one (``mark_resident``).  The paged decode step
(``models.lm.decode_step_paged``) appends each new token's K/V straight
into the tail block on device.  The host-side bookkeeping is the
reference's line for line; where the reference writes ``.at[...].set``
into a new array, the port writes the same blocks in place with
``index_put_`` (tensor indexing assignment).

With an ``env`` on a mesh the two tensors are DTensors laid out by
``pool_sharding`` (``models.lm.decode_step_paged`` says why): every rank
holds a replica of every block, with all the kv heads or, where they
split over 'model', its ``K / tp`` of them.  Each rank runs the same host
bookkeeping; the methods that land KV take it whole and write the rank's
kv heads, and ``resume`` gathers them back, so ``export_kv`` hands over
whole (L, n, K, dh) tensors on every rank.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pool_sharding(env, shape):
    """The pool's layout on ``env``'s mesh, for a pool of ``shape`` (L,
    blocks, block, K, dh): replicated over 'data' (and 'pod'), its kv heads
    over 'model' where ``K % tp == 0``, else replicated there too."""
    return env.named(shape, [None, None, None, "model", None])


class PagedKVPool:
    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 headroom_blocks: int = 0, device="cuda", env=None):
        self.L = n_layers
        # nominal (policy-visible) capacity: what WA-LRU/TTL budget against
        self.num_blocks = num_blocks
        # physical capacity: nominal + the engine's resident headroom
        self.total_blocks = num_blocks + headroom_blocks
        self.block = block_size
        self.K = n_kv_heads
        self.dh = head_dim
        self.device = torch.device(device)
        shape = (n_layers, self.total_blocks, block_size, n_kv_heads,
                 head_dim)
        self.env = env if env is not None and env.mesh is not None else None
        self.heads = slice(0, n_kv_heads)      # the kv heads this rank holds
        if self.env is None:
            self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
            self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        else:
            self.k_pool, self.v_pool = (self._sharded_zeros(shape, dtype)
                                        for _ in range(2))
        self.free: List[int] = list(range(self.total_blocks))
        self.tables: Dict[str, List[int]] = {}
        self.lens: Dict[str, int] = {}
        # slot-bound sessions: their blocks live in the headroom and are
        # invisible to the parked-capacity accounting below
        self.resident: Set[str] = set()

    def _sharded_zeros(self, shape, dtype):
        """A zero DTensor of ``shape`` laid out by ``pool_sharding``, made
        from this rank's shard alone; sets ``heads``."""
        from torch.distributed.tensor import DTensor
        from repro_torch.models.sharding import axis_index, contiguous_strides
        sh = pool_sharding(self.env, shape)
        local = sh.shard_shape(shape)
        k0 = axis_index(self.env, sh.spec[3]) * local[3]
        self.heads = slice(k0, k0 + local[3])
        return DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=self.device),
            self.env.mesh, sh.placements, run_check=False,
            shape=torch.Size(shape), stride=contiguous_strides(shape))

    def _locals(self):
        """This rank's (k, v) pool tensors (the pools themselves with no
        mesh)."""
        if self.env is None:
            return self.k_pool, self.v_pool
        return self.k_pool.to_local(), self.v_pool.to_local()

    # -- accounting ------------------------------------------------------
    @property
    def bytes_per_block(self) -> int:
        return int(2 * self.L * self.block * self.K * self.dh * 2)

    def used_blocks(self) -> int:
        """Blocks held by PARKED sessions — the policy-visible usage a
        gather-mode pool would report (resident sessions hold no parked
        blocks there either: their KV lives in the slot cache)."""
        return sum(len(t) for sid, t in self.tables.items()
                   if sid not in self.resident)

    def physical_used_blocks(self) -> int:
        return self.total_blocks - len(self.free)

    def audit_blocks(self) -> List[Tuple[str, Optional[str]]]:
        """Block-conservation audit: every block id must live in exactly
        one place — the free list or exactly one session's table.
        Returns (message, owning_session_or_None) per violation; empty
        when the pool is consistent.  A double-release shows up as a
        block both free and owned (or twice free); a leak as a block in
        neither."""
        errs: List[Tuple[str, Optional[str]]] = []
        owner: Dict[int, str] = {}
        for sid in sorted(self.tables):
            for b in self.tables[sid]:
                if b in owner:
                    errs.append((f"block {b} owned by both "
                                 f"{owner[b]!r} and {sid!r}", sid))
                elif not 0 <= b < self.total_blocks:
                    errs.append((f"block {b} of {sid!r} out of range",
                                 sid))
                else:
                    owner[b] = sid
        seen_free = set()
        for b in self.free:
            if b in seen_free:
                errs.append((f"block {b} on the free list twice "
                             "(double-release)", None))
            elif b in owner:
                errs.append((f"block {b} both free and owned by "
                             f"{owner[b]!r} (double-release)",
                             owner[b]))
            seen_free.add(b)
        lost = sorted(set(range(self.total_blocks)) - seen_free
                      - set(owner))
        if lost:
            errs.append((f"blocks {lost[:8]} in no table and not free "
                         "(leaked)", None))
        if self.used_blocks() > self.num_blocks:
            errs.append((f"parked blocks {self.used_blocks()} exceed "
                         f"nominal capacity {self.num_blocks}", None))
        stale = sorted(self.resident - set(self.tables))
        if stale:
            errs.append((f"resident sessions with no table: {stale[:5]}",
                         stale[0]))
        return errs

    def session_bytes(self, sid: str) -> int:
        return len(self.tables.get(sid, [])) * self.bytes_per_block

    def has(self, sid: str) -> bool:
        return sid in self.tables

    # -- alloc/free --------------------------------------------------------
    def _blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block)

    def can_fit(self, tokens: int) -> bool:
        """Policy-visible capacity check for PARKING ``tokens`` worth of
        KV: resident sessions ride in the headroom and do not count.
        (Gather mode: resident is empty, so this degenerates to the old
        free-list check.)"""
        return self._blocks_for(tokens) <= \
            self.num_blocks - self.used_blocks()

    def free_session(self, sid: str) -> int:
        blocks = self.tables.pop(sid, [])
        self.lens.pop(sid, None)
        self.resident.discard(sid)
        self.free.extend(blocks)
        return len(blocks)

    # -- allocate-at-admit (paged decode) ---------------------------------
    def alloc(self, sid: str) -> None:
        """Bind ``sid`` as a resident session with an empty table;
        prefill then lands straight into blocks via :meth:`extend` and a
        decode slot becomes just a batch-row binding.  A stale parked
        table (a coordinator miss whose old blocks survived) is freed
        first — that prefix is about to be regenerated anyway."""
        if sid in self.tables:
            self.free_session(sid)
        self.tables[sid] = []
        self.lens[sid] = 0
        self.resident.add(sid)

    def extend(self, sid: str, k: torch.Tensor, v: torch.Tensor,
               n_new: Optional[int] = None, *,
               bucket: Optional[int] = None) -> None:
        """Append contiguous KV (L, n, K, dh) at the session's current
        end, drawing tail blocks from the free list.  One scatter lands
        all n tokens (mid-block starts supported: a resume's delta
        prefill continues the partially-filled tail block).

        ``bucket`` is the caller's prefill compile quantum; it must be a
        whole number of blocks so a compile-bucket boundary never splits
        a tail block (the engine pads prefill lengths to
        lcm(bucket, block))."""
        assert bucket is None or bucket % self.block == 0, \
            f"prefill bucket {bucket} not a multiple of block {self.block}"
        n_new = int(k.shape[1]) if n_new is None else int(n_new)
        if n_new == 0:
            return
        start = self.lens[sid]
        end = start + n_new
        tbl = self.tables[sid]
        need = self._blocks_for(end) - len(tbl)
        assert need <= len(self.free), \
            f"pool headroom exhausted extending {sid!r}"
        for _ in range(need):
            tbl.append(self.free.pop())
        tok = np.arange(start, end)
        bids = torch.as_tensor([tbl[i] for i in tok // self.block],
                               dtype=torch.long, device=self.device)
        offs = torch.as_tensor(tok % self.block, dtype=torch.long,
                               device=self.device)
        kp, vp = self._locals()
        kp[:, bids, offs] = k[:, :n_new, self.heads].to(kp.dtype)
        vp[:, bids, offs] = v[:, :n_new, self.heads].to(vp.dtype)
        self.lens[sid] = end

    def extend_parked(self, sid: str, k: torch.Tensor, v: torch.Tensor,
                      n_new: Optional[int] = None) -> bool:
        """Append contiguous delta KV behind a PARKED session's prefix —
        the landing half of a prefill→decode handoff on a cache hit: the
        parked prefix blocks stay put and the handed-off delta appends
        behind them (mid-block starts supported, same scatter as
        :meth:`extend`).  Unlike ``extend``, the new blocks join the
        parked population, so the draw is checked against the NOMINAL
        capacity; returns False (caller evicts or cancels the handoff)
        when the delta would not fit."""
        assert sid in self.tables and sid not in self.resident, \
            f"extend_parked of non-parked session {sid!r}"
        n_new = int(k.shape[1]) if n_new is None else int(n_new)
        need = self._blocks_for(self.lens[sid] + n_new) \
            - len(self.tables[sid])
        if need > self.num_blocks - self.used_blocks():
            return False
        self.extend(sid, k, v, n_new)
        return True

    def ensure_tail_room(self, sid: str) -> None:
        """Guarantee the next appended token has a destination block
        (the resident headroom makes this draw infallible)."""
        tbl = self.tables[sid]
        if self.lens[sid] == len(tbl) * self.block:
            assert self.free, f"pool headroom exhausted for {sid!r}"
            tbl.append(self.free.pop())

    def tail_slot(self, sid: str) -> Tuple[int, int]:
        """(block id, in-block offset) where the NEXT token's K/V lands
        — the paged decode step's append destination."""
        n = self.lens[sid]
        return self.tables[sid][n // self.block], n % self.block

    def append_token(self, sid: str) -> None:
        """Account one decoded token whose K/V the device step already
        wrote into the tail block (see ``tail_slot``)."""
        n = self.lens[sid]
        assert n < len(self.tables[sid]) * self.block, \
            f"append past tail block of {sid!r} (ensure_tail_room missed)"
        self.lens[sid] = n + 1

    # -- resident <-> parked (metadata-only park / resume) ----------------
    def park_resident(self, sid: str) -> bool:
        """Metadata-only park of a slot-bound session: the blocks stay
        put; the session merely moves from resident (headroom) to parked
        (nominal-capacity) accounting.  Returns False — caller evicts
        and retries — when the parked set would exceed nominal capacity,
        exactly where a gather-mode park would have failed."""
        assert sid in self.resident and sid in self.tables
        if len(self.tables[sid]) > self.num_blocks - self.used_blocks():
            return False
        self.resident.discard(sid)
        return True

    def mark_resident(self, sid: str) -> None:
        """Metadata-only resume: a parked session joins a decode slot;
        its blocks move from parked to headroom accounting."""
        assert sid in self.tables and sid not in self.resident
        self.resident.add(sid)

    # -- park / resume (gather transport) ---------------------------------
    def park(self, sid: str, k: torch.Tensor, v: torch.Tensor,
             n_tokens: int) -> bool:
        """Store contiguous KV (L, S, K, dh) into freshly drawn pool
        blocks (paged-mode migration import, disaggregated staging).
        Returns False (caller must evict) if no space — checked on NET
        demand *before* any old table is freed, so a failed re-park
        never destroys the KV it was replacing."""
        assert sid not in self.resident, \
            f"park of resident session {sid!r} (use park_resident)"
        n_tokens = int(n_tokens)
        nb = self._blocks_for(n_tokens)
        owned = len(self.tables.get(sid, []))
        if nb - owned > self.num_blocks - self.used_blocks():
            return False
        if sid in self.tables:
            self.free_session(sid)
        blocks = [self.free.pop() for _ in range(nb)]
        pad = nb * self.block - n_tokens
        # F.pad's pairs run from the last dim: (dh), (K), then tokens
        k = F.pad(k[:, :n_tokens], (0, 0, 0, 0, 0, pad))
        v = F.pad(v[:, :n_tokens], (0, 0, 0, 0, 0, pad))
        kb = k.reshape(self.L, nb, self.block, self.K, self.dh)
        vb = v.reshape(self.L, nb, self.block, self.K, self.dh)
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        kp, vp = self._locals()
        kp[:, idx] = kb[:, :, :, self.heads].to(kp.dtype)
        vp[:, idx] = vb[:, :, :, self.heads].to(vp.dtype)
        self.tables[sid] = blocks
        self.lens[sid] = n_tokens
        return True

    def resume(self, sid: str) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                                 int]]:
        """Copy a session's blocks out to contiguous (L, S, K, dh) — the
        transport half of a cross-engine migration or a handoff (only the
        owned blocks are copied)."""
        blocks = self.tables.get(sid)
        if blocks is None:
            return None
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        kp, vp = self._locals()
        n = self.lens[sid]
        k = kp[:, idx].reshape(self.L, -1, kp.shape[3], self.dh)[:, :n]
        v = vp[:, idx].reshape(self.L, -1, vp.shape[3], self.dh)[:, :n]
        if kp.shape[3] != self.K:       # this rank's kv heads: gather them
            from repro_torch.models.sharding import all_gather
            k, v = (all_gather(t, self.env, "model", 2) for t in (k, v))
        return k, v, n

    def block_table_array(self, sid: str, max_blocks: int) -> np.ndarray:
        """Padded int32 block table (host array) for the paged-decode
        kernel."""
        blocks = self.tables.get(sid, [])
        out = np.zeros((max_blocks,), np.int32)
        out[:len(blocks)] = blocks
        return out

"""Real-JAX serving layer: paged KV pool, engines, and the event-driven
concurrent runtime under the SAGA coordinator.

Architecture map (module -> paper section):

  * ``kvcache.PagedKVPool`` — PagedAttention-style block pool and the
    *only* home a session's KV ever has: blocks are allocated at admit
    (``alloc``/``extend``), the decode step appends into the tail block
    (``ensure_tail_room``/``append_token``), and WA-LRU / TTL decisions
    (§4.1-§4.2) mutate only block tables, never device memory.
    Capacity is split nominal/headroom: parked sessions compete for the
    ``num_blocks`` the coordinator meters, while resident (decoding)
    sessions draw from a per-slot headroom — so paged and gather modes
    make bit-identical park/evict/admit policy decisions.
  * ``engine.Engine`` — one worker: jitted prefill scattered straight
    into pool blocks + continuous-batching decode that attends over
    per-slot block tables (``lm.decode_step_paged``), appending each new
    token's K/V on device.  Park / resume / AFS preemption are pure
    metadata flips (``park_resident``/``mark_resident`` — zero device
    copies, counted in ``stats()`` as ``park_copy_bytes`` /
    ``resume_copy_bytes`` staying 0); resume prefills only the context
    delta.  KV export/import for pool-to-pool migration still copies,
    but only the session's owned blocks.  ``Engine(paged=False)`` keeps
    the original contiguous-slot gather path as the reference oracle —
    both modes emit bit-identical token ids.  Admission is
    non-asserting: a full engine returns ``None`` and the runtime
    queues.
  * ``events`` — deterministic virtual-time event heap + AFS-ordered
    ``SessionQueue`` (§6 admission); the byte-identical replay
    substrate.
  * ``runtime.ServingRuntime`` — the serving twin of the discrete-event
    simulator, on real forward passes: workflow-atomic interleaving of
    concurrent agent sessions (§3.1), AEG-guided reuse via the shared
    ``GlobalCoordinator`` (§3.2-§3.3), Eq. 7 affinity routing +
    work stealing with real KV block migration (§5), speculative
    prefetch as real pool-to-pool copies overlapping tool gaps (§4.3),
    and the 100 ms incremental AFS epoch tick (§6).

    Submission is the unified ``repro_torch.workflow.AgentProgram`` API —
    scripted (legacy ``AgentRequest``s compile to it byte-identically),
    explicit-graph (declared AEG + seeded branch resolution: retry and
    conditional edges execute, and the scheduler sees the true
    structure), and dynamic (a client callback decides each next step
    from the real decoded tokens at park/resume boundaries).
    ``submit`` returns a ``WorkflowHandle`` (``result()`` /
    ``step_outputs`` / ``status`` / taken ``path``).
  * ``disagg`` — disaggregated prefill/decode pools (opt-in via
    ``SAGAConfig.disaggregate``; ``docs/DISAGG.md``): engines declare
    roles, a deterministic ``PrefillScheduler`` owns the prefill pool
    (new-session and tool-resume prefills, speculative prefill
    overlapping tool gaps), and finished KV hands off to the decode
    pool block-granularly (``stage_prefill`` → ``export_kv`` →
    ``import_handoff``) over a deterministic transfer window; Eq. 7
    affinity then routes *decode* placement only.  Every handoff job
    is attempt-stamped so an engine dying mid-handoff cancels cleanly
    and re-prefills token-identically.
  * ``client.SagaClient`` — THE submission surface (``for_runtime`` /
    ``for_server`` / ``for_simulation`` / ``for_driver``):
    ``client.submit(program_or_request, tenant=, slo=)`` returns a
    ``WorkflowHandle`` on every substrate; see docs/SERVING_API.md.
  * ``schema`` — the documented ``stats()`` / ``summarize()`` key
    vocabulary (``summarize()`` repr is the byte-identity pin; new
    wall-clock keys live in ``AsyncServingDriver.wall_stats``).
  * ``frontend`` — the wall-clock production surface (ROADMAP item 3):
    ``AsyncServingDriver`` pumps the SAME event heap under asyncio
    pacing (fake-clock mode replays the virtual run byte-identically),
    ``SagaHTTPProxy`` speaks OpenAI-compatible chat completions with
    ``X-Session-Id``/``X-Task-Id``/``X-Program-Id`` tracking headers,
    pluggable load-balancing strategies, ``TrackedRequest`` lifecycle
    accounting, and a Prometheus ``/metrics`` endpoint.
  * ``server.MultiWorkerServer`` — legacy blocking facade: a thin
    serial wrapper over the runtime (deprecated shim; use
    ``SagaClient``).
  * ``sanitizer.RuntimeSanitizer`` — read-only per-event conservation
    auditor (``SAGA_SANITIZE=1`` / ``ServingRuntime(sanitize=True)``):
    block/slot ownership, incremental indices, and registry stamps
    re-checked after every dispatched event, failing at the first bad
    event with the owning session and attempt named (see
    ``docs/INVARIANTS.md``).
  * ``repro_torch.obs`` (``SAGA_TRACE=1`` / ``ServingRuntime(trace=True)``)
    — virtual-time span tracer + metrics registry hooked into the same
    semantic points on both substrates: per-session span trees
    (queue_wait / prefill / resume / decode / tool_gap / migration,
    engine rounds, preempt / cancel / prefetch / fault instants) and
    epoch-tick gauges (queue depth, KV pool occupancy, AFS deviation).
    Read-only by contract: traced ``summarize()`` is byte-identical to
    untraced, trace bytes identical across ``PYTHONHASHSEED``.
    Exports Perfetto ``trace_event`` JSON, Prometheus text, and the
    per-phase TCT decomposition (see ``docs/OBSERVABILITY.md``).

Fault / preemption lifecycle (runtime twin of the simulator's
attempt-stamped registry; ``cluster.faults`` plans drive both
substrates)::

              route                prefill_done             step done
   [queued] --------> [prefill] ---------------> [decode] -----------+
      ^  ^   admit        |    (attempt-stamped)   |  |              |
      |  |                | fail: attempt          |  | fail:        v
      |  |                | cancelled, ctx         |  | rollback   [tool]
      |  |                | rolled back,           |  | + retry      |
      |  |                v re-dispatch            |  v              |
      |  |           (re-route / orphan <----------+ orphan if       |
      |  |            buffer if no engine alive;     all dead)       |
      |  |            recover / scale_up readmits)                   |
      |  |                                         epoch tick:       |
      |  |   AFS preemption (deficit > threshold,  decide victim     |
      |  |   blocked > preempt_block_s, Thm. 2     at round          |
      |  |   under/over-served check)              boundary          |
      |  +--------------------------------- [decode victim parked:   |
      |      re-enqueued mid-step (delta-    slot KV -> pool, TTL    |
      |      only resume finishes the step   entry, starved head     |
      |      token-for-token identically)    admitted]               |
      +--------------------------------------------------------------+
                     tool_done -> next step (resume hits pool KV,
                     or regenerates from the last parked prefix if a
                     fault / eviction took it — §3.1)

   Engine ``fail`` wipes slots + block tables + coordinator pool
   metadata + affinities, cancels in-flight prefetch copies sourced
   there (counted as waste), refunds partially-charged AFS work, and
   requeues the pending queue on live engines.  ``check_conservation``
   asserts admitted == finished and zero slot/KV-block leak after every
   run, chaos plans included — and identical-seed runs stay
   byte-identical across ``PYTHONHASHSEED`` under all of it.
"""

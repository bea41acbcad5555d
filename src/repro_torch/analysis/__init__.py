"""Static analysis + runtime sanitization for the SAGA scheduler tree.

The repo's two hard invariants are byte-identical replay (identical
seeds produce identical ``summarize()`` reprs across processes and
``PYTHONHASHSEED``) and conservation (admitted == finished, zero
slot/KV-block/AFS leak).  Both were enforced only after the fact — by
golden fingerprints and end-of-run ``check_conservation`` — which
localizes a violation to a whole run, not a line.  This package closes
that gap:

  * ``sagalint`` — an AST-based linter (``python -m
    repro_torch.analysis.sagalint src/repro_torch``) with two rule families:
    determinism (builtin ``hash``, unordered-iteration order leaks,
    wall-clock reads, unseeded RNG, ``os.environ`` in hot paths) and
    resource lifecycle (CFG walk for acquire-without-release paths,
    event handlers missing attempt-stamp guards).  Suppressible only
    via an explicit ``# sagalint: ok(<rule>) <reason>`` pragma.
  * the runtime sanitizer lives next to the runtime it audits
    (``repro_torch.serving.sanitizer``): shadow block-refcount / slot
    ownership checks at every event-loop boundary, failing at the
    first bad event with the owning session/attempt named.

Everything here is stdlib-only (``ast`` + ``argparse``) so the CI lint
job runs with no third-party installs.

See ``docs/INVARIANTS.md`` for the rule catalogue with bad/good
examples and the pragma format.

(Import ``repro_torch.analysis.sagalint`` directly for the API — this
``__init__`` stays empty so ``python -m repro_torch.analysis.sagalint`` does
not double-import the driver module.)
"""

"""Resource-lifecycle rule family.

The runtime and simulator share a vocabulary of acquire/release pairs;
a path that acquires one and exits a handler without releasing it or
handing it off is exactly the class of bug ``check_conservation`` only
catches at end-of-run:

  ================  ==========================  =========================
  family            acquire                     release
  ================  ==========================  =========================
  slot              ``start_session``           ``release_session`` /
                                                ``park_session`` /
                                                ``fail``
  blocks            ``park`` / ``import_kv`` /  ``free_session`` /
                    ``import_handoff`` /        ``evict_session`` /
                    ``stage_prefill`` /         ``_handoff_abort``
                    ``*pool*.alloc`` /
                    ``*pool*.extend`` /
                    ``*pool*.ensure_tail_room``
  afs-work          ``note_progress``           ``refund_work``
  inflight          ``X.inflight[sid] = ...``   ``X.inflight.pop`` /
                                                ``del X.inflight[...]``
  idle-set          ``on_worker_busy``          ``on_worker_idle``
  span              ``*tracer*.begin``          ``*tracer*.end``
  ================  ==========================  =========================

Paged serving moved block acquisition from park-time to admit-time
(allocate-at-admit: ownership spans admit→finish, and park/resume are
metadata-only flips that neither acquire nor release).  The alloc-side
names are too generic to match bare (``list.extend`` is everywhere), so
they only count when called through a receiver chain that passes a
``pool`` attribute or name — ``self.pool.alloc(sid)``,
``eng.pool.extend(...)``.

Rules:

  * ``life-leak``  — within one function whose body both acquires a
    family and releases it (or performs a registered handoff —
    scheduling a continuation event owns the release downstream), any
    CFG path from an acquire to function exit that passes neither is
    flagged.  ``raise`` exits are exempt: crashing on a violated
    invariant is not a leak.
  * ``life-guard`` — event handlers (``_on_*`` methods, the
    ``getattr(self, "_on_" + kind)`` dispatch convention) that receive
    a staleness stamp (a parameter named ``attempt`` / ``gen`` /
    ``generation``) but never test it: stale events from a cancelled
    attempt or a failed engine incarnation would then mutate fresh
    state.
  * ``life-span`` — the ``span`` family under the ``life-leak``
    analysis, reported under its own rule id: a ``tracer.begin(...)``
    on a path that exits without ``tracer.end(...)`` or a registered
    handoff is a span leak — ``Tracer.check_closed()`` would only
    catch it at end-of-run, like a leaked slot.  ``begin``/``end`` are
    far too generic to match bare, so the family is receiver-scoped:
    calls classify only through a chain passing a ``tracer`` name
    (``self.tracer.begin(...)``), mirroring the pool-scoped alloc
    names.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.cfg import CFG, Node
from repro_torch.analysis.sagalint import Finding

FAMILIES: Dict[str, Dict[str, Set[str]]] = {
    "slot": {
        "acquire": {"start_session"},
        "release": {"release_session", "park_session", "fail"},
    },
    "blocks": {
        "acquire": {"park", "import_kv", "import_handoff",
                    "stage_prefill"},
        # _handoff_abort unwinds a disaggregated handoff attempt: it
        # evicts the staged prefill-side copy and returns the staging
        # reservation, so it is a blocks release in the runtime's
        # vocabulary
        "release": {"free_session", "evict_session", "_handoff_abort"},
    },
    "afs-work": {
        "acquire": {"note_progress"},
        "release": {"refund_work"},
    },
    "idle-set": {
        "acquire": {"on_worker_busy"},
        "release": {"on_worker_idle"},
    },
    # virtual-time span tracer (repro_torch.obs.tracer): ``begin``/``end``
    # are too generic to match bare, so the optional "receivers" key
    # scopes classification to calls whose receiver chain passes a
    # ``tracer`` name — self.tracer.begin(...), sim.tracer.end(...)
    "span": {
        "acquire": {"begin"},
        "release": {"end"},
        "receivers": {"tracer"},
    },
}

# calls that transfer ownership of whatever this function acquired to a
# later event / another queue / the terminal completion path: the
# matching release happens there
HANDOFF_CALLS = {
    "schedule", "_push", "_queue_push", "_redispatch", "_dispatch_to",
    "_enqueue", "_admit", "resolve", "_finish_task",
}

# joining a live continuous-batching round (self._active[w].add(sid))
# also hands the slot off — the round loop owns its release from there
_JOIN_ATTRS = {"_active"}

# allocate-at-admit block acquires (paged serving): bare names are too
# generic (`list.extend`, arena `alloc` helpers), so they only classify
# when the call's receiver chain passes a KV pool
_POOL_SCOPED_ACQUIRES = {"alloc", "extend", "extend_parked",
                         "ensure_tail_room"}
_POOL_RECEIVERS = {"pool"}

STAMP_PARAMS = ("attempt", "gen", "generation")


def _callee(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_inflight_chain(node: ast.AST) -> bool:
    """Does the expression end in an attribute/name called 'inflight'?"""
    if isinstance(node, ast.Attribute):
        return node.attr == "inflight"
    if isinstance(node, ast.Name):
        return node.id == "inflight"
    return False


def _chain_mentions(node: ast.AST, names: Set[str]) -> bool:
    """Does an attribute/subscript chain pass through one of ``names``?
    (``self._active[w]`` mentions ``_active``.)"""
    while True:
        if isinstance(node, ast.Attribute):
            if node.attr in names:
                return True
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id in names
        else:
            return False


class _NodeActions:
    """Acquire/release/handoff classification of one CFG node."""

    def __init__(self, node: Node) -> None:
        self.acquires: Set[str] = set()
        self.releases: Set[str] = set()
        self.handoff = False
        for frag in node.frags:
            for sub in ast.walk(frag):
                self._classify(sub)

    def _classify(self, sub: ast.AST) -> None:
        if isinstance(sub, ast.Call):
            callee = _callee(sub)
            if callee in HANDOFF_CALLS:
                self.handoff = True
            if callee == "add" and isinstance(sub.func, ast.Attribute) \
                    and _chain_mentions(sub.func.value, _JOIN_ATTRS):
                self.handoff = True
            for fam, names in FAMILIES.items():
                recv = names.get("receivers")
                if recv is not None and not (
                        isinstance(sub.func, ast.Attribute)
                        and _chain_mentions(sub.func.value, recv)):
                    continue
                if callee in names["acquire"]:
                    self.acquires.add(fam)
                if callee in names["release"]:
                    self.releases.add(fam)
            if callee in _POOL_SCOPED_ACQUIRES \
                    and isinstance(sub.func, ast.Attribute) \
                    and _chain_mentions(sub.func.value, _POOL_RECEIVERS):
                self.acquires.add("blocks")
            # X.inflight.pop(...)
            if callee == "pop" and isinstance(sub.func, ast.Attribute) \
                    and _is_inflight_chain(sub.func.value):
                self.releases.add("inflight")
        elif isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Subscript) and \
                        _is_inflight_chain(t.value):
                    self.acquires.add("inflight")
        elif isinstance(sub, ast.Delete):
            for t in sub.targets:
                if isinstance(t, ast.Subscript) and \
                        _is_inflight_chain(t.value):
                    self.releases.add("inflight")


class LifecycleChecker:
    def __init__(self, path: str) -> None:
        self.path = path
        self.findings: List[Finding] = []

    def run(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_leaks(node)
                self._check_guard(node)

    # -- life-leak -------------------------------------------------------
    def _check_leaks(self, fn: ast.FunctionDef) -> None:
        cfg = CFG(fn)
        actions = {nid: _NodeActions(n) for nid, n in cfg.nodes.items()}
        any_handoff = any(a.handoff for a in actions.values())
        families = sorted(
            {f for a in actions.values() for f in a.acquires})
        for fam in families:
            has_release = any(fam in a.releases
                              for a in actions.values())
            if not (has_release or any_handoff):
                # purely-acquiring helper: its caller owns the release;
                # nothing to pair against locally
                continue
            barriers = {nid for nid, a in actions.items()
                        if fam in a.releases or a.handoff}
            for nid, a in sorted(actions.items()):
                if fam not in a.acquires or nid in barriers:
                    continue
                if isinstance(cfg.nodes[nid].stmt, ast.Return):
                    # tail acquire: the resource (or its success flag)
                    # is returned — ownership escapes to the caller
                    continue
                witness = cfg.reaches_exit(nid, barriers)
                if witness is None:
                    continue
                node = cfg.nodes[nid]
                exit_line = cfg.nodes[witness[-1]].line \
                    if witness else node.line
                rel = " / ".join(sorted(FAMILIES[fam]["release"])) \
                    if fam in FAMILIES \
                    else "inflight.pop / del inflight[...]"
                rule = "life-span" if fam == "span" else "life-leak"
                self.findings.append(Finding(
                    self.path, node.line, node.stmt.col_offset,
                    rule,
                    f"'{fn.name}' acquires {fam} here but the path "
                    f"exiting at line {exit_line} neither releases it "
                    f"({rel}) nor hands it off to a scheduled "
                    "continuation"))

    # -- life-guard ------------------------------------------------------
    def _check_guard(self, fn: ast.FunctionDef) -> None:
        if not fn.name.startswith("_on_"):
            return
        params = [a.arg for a in fn.args.args + fn.args.kwonlyargs
                  if a.arg in STAMP_PARAMS]
        for p in params:
            if not self._validated(fn, p):
                self.findings.append(Finding(
                    self.path, fn.lineno, fn.col_offset, "life-guard",
                    f"event handler '{fn.name}' receives staleness "
                    f"stamp '{p}' but never validates it — a stale "
                    "event from a cancelled attempt / dead engine "
                    "incarnation would mutate fresh state"))

    @staticmethod
    def _validated(fn: ast.FunctionDef, param: str) -> bool:
        """The stamp counts as validated when it appears inside any
        branch test or comparison (the canonical guard is
        ``if rec is None or rec[1] != attempt: return``)."""
        tests: List[ast.AST] = []
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.If, ast.While, ast.IfExp)):
                tests.append(sub.test)
            elif isinstance(sub, ast.Assert):
                tests.append(sub.test)
            elif isinstance(sub, ast.Compare):
                tests.append(sub)
        for t in tests:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name) and sub.id == param:
                    return True
        return False

"""Determinism rule family.

The scheduler's contract is byte-identical replay across processes and
``PYTHONHASHSEED`` values.  Every rule here flags a construct that can
silently break it:

  * ``det-hash``     builtin ``hash()`` on non-ints — randomized per
                     process for str/bytes; use the repo's FNV-1a
                     helpers (``_fnv1a`` in ``cluster.simulator`` /
                     ``workflow.program``).
  * ``det-set-order`` iteration order of a ``set`` / ``dict.keys()``
                     escaping into an ordering-sensitive sink: a
                     ``min``/``max``/``sorted`` whose key is not a
                     provable total order, ``next(iter(s))`` /
                     ``s.pop()`` arbitrary-element selection, or a
                     ``for`` over a set whose body pushes work or
                     mutates shared state.
  * ``det-clock``    wall-clock reads (``time.time``,
                     ``datetime.now``, ...) — virtual time only.
  * ``det-rng``      module-global or unseeded RNG (``random.*``,
                     ``np.random.*``, no-arg ``Random()`` /
                     ``RandomState()`` / ``default_rng()``).
  * ``det-env``      ``os.environ`` / ``os.getenv`` reads — config
                     must flow through constructors, not ambient
                     process state.

Set-typedness is inferred flow-insensitively: set literals/calls,
``.keys()``, set-operator results, ``self`` attributes assigned or
annotated as sets anywhere in the class (including ``List[set]``
element access), annotated parameters, and locals assigned from any of
those.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.sagalint import Finding

CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.clock_gettime",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today", "date.today",
    # asyncio's wall clock by idiomatic receiver name — permitted only
    # inside repro_torch/serving/frontend via sagalint's SCOPE_EXEMPT
    # configuration (the asyncio driver's charter), never by pragma
    "loop.time", "asyncio.get_event_loop.time",
    "asyncio.get_running_loop.time",
}

# random-module functions whose call implies the process-global stream
_RANDOM_FUNCS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "triangular", "vonmisesvariate",
    "paretovariate", "getrandbits", "seed",
}
_RNG_CTORS = {"Random", "RandomState", "default_rng", "Generator",
              "SeedSequence"}

# calls that enqueue/schedule work: a set-ordered loop feeding one of
# these makes dispatch order depend on hash iteration order
SINK_CALLS = {
    "_queue_push", "_enqueue", "_push", "_admit", "_dispatch_to",
    "_redispatch", "schedule", "heappush", "push",
}

_SET_OPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested attribute access rooted at a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ann_is_set(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id in ("set", "Set", "frozenset", "FrozenSet")
    if isinstance(ann, ast.Subscript):        # Set[int], typing.Set[...]
        return _ann_is_set(ann.value)
    if isinstance(ann, ast.Attribute):        # typing.Set
        return ann.attr in ("Set", "FrozenSet")
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        s = ann.value.strip()
        return s.startswith(("set", "Set[", "Set", "frozenset"))
    return False


def _ann_is_setlist(ann: Optional[ast.AST]) -> bool:
    """List[set] / Sequence[Set[...]] — element access is a set."""
    if isinstance(ann, ast.Subscript):
        base = ann.value
        basename = base.id if isinstance(base, ast.Name) else \
            base.attr if isinstance(base, ast.Attribute) else ""
        if basename in ("List", "list", "Sequence", "Tuple", "tuple"):
            return _ann_is_set(ann.slice)
    return False


def _value_is_setlist(node: ast.AST) -> bool:
    if isinstance(node, ast.ListComp):
        return _value_makes_set(node.elt, set(), set())
    if isinstance(node, ast.List) and node.elts:
        return all(_value_makes_set(e, set(), set()) for e in node.elts)
    return False


def _value_makes_set(node: ast.AST, set_locals: Set[str],
                     set_attrs: Set[str]) -> bool:
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        if isinstance(f, ast.Attribute) and f.attr == "keys":
            return True
        # set.copy()/union()/... preserve unorderedness
        if isinstance(f, ast.Attribute) and f.attr in (
                "copy", "union", "intersection", "difference",
                "symmetric_difference") and _value_makes_set(
                    f.value, set_locals, set_attrs):
            return True
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, _SET_OPS):
        return (_value_makes_set(node.left, set_locals, set_attrs)
                or _value_makes_set(node.right, set_locals, set_attrs))
    if isinstance(node, ast.Name):
        return node.id in set_locals
    if isinstance(node, ast.Attribute):
        return (isinstance(node.value, ast.Name)
                and node.value.id == "self" and node.attr in set_attrs)
    return False


class _ClassTypes(ast.NodeVisitor):
    """Collect self-attributes that hold sets (or lists of sets)
    anywhere in a class body."""

    def __init__(self) -> None:
        self.set_attrs: Set[str] = set()
        self.setlist_attrs: Set[str] = set()

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        t = node.target
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            if _ann_is_set(node.annotation):
                self.set_attrs.add(t.attr)
            elif _ann_is_setlist(node.annotation):
                self.setlist_attrs.add(t.attr)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                if _value_makes_set(node.value, set(), self.set_attrs):
                    self.set_attrs.add(t.attr)
                elif _value_is_setlist(node.value):
                    self.setlist_attrs.add(t.attr)
        self.generic_visit(node)


class DeterminismChecker(ast.NodeVisitor):
    """One pass over a module; collects findings on ``self.findings``."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.findings: List[Finding] = []
        self._class_types: Dict[str, _ClassTypes] = {}
        self._cls_stack: List[str] = []
        self._set_locals_stack: List[Set[str]] = [set()]

    # -- context --------------------------------------------------------
    @property
    def _types(self) -> Optional[_ClassTypes]:
        return self._class_types.get(self._cls_stack[-1]) \
            if self._cls_stack else None

    @property
    def _set_locals(self) -> Set[str]:
        return self._set_locals_stack[-1]

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, msg))

    def _unordered(self, node: ast.AST) -> bool:
        t = self._types
        if _value_makes_set(node, self._set_locals,
                            t.set_attrs if t else set()):
            return True
        # element of a list-of-sets attribute: self._active[w]
        if isinstance(node, ast.Subscript) and t is not None:
            v = node.value
            if isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name) and \
                    v.value.id == "self" and v.attr in t.setlist_attrs:
                return True
        return False

    # -- scoping --------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        ct = _ClassTypes()
        ct.visit(node)
        self._class_types[node.name] = ct
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_fn(self, node) -> None:
        locs: Set[str] = set()
        for a in node.args.args + node.args.kwonlyargs:
            if _ann_is_set(a.annotation):
                locs.add(a.arg)
        t = self._types
        attrs = t.set_attrs if t else set()
        # flow-insensitive: two fixpoint-ish sweeps pick up chained
        # assignments (a = set(); b = a)
        for _ in range(2):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and \
                        _value_makes_set(sub.value, locs, attrs):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            locs.add(tgt.id)
        self._set_locals_stack.append(locs)
        self.generic_visit(node)
        self._set_locals_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- det-env --------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _dotted(node) == "os.environ":
            self._emit(node, "det-env",
                       "os.environ read in scheduler code — pass "
                       "configuration through constructors so replay "
                       "does not depend on ambient process state")
        self.generic_visit(node)

    # -- call-shaped rules ----------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        name = _dotted(f)
        if isinstance(f, ast.Name) and f.id == "hash":
            if not (node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, int)):
                self._emit(node, "det-hash",
                           "builtin hash() is randomized per process "
                           "for str/bytes — use the FNV-1a helper "
                           "(_fnv1a) for stable hashing")
        elif name in CLOCK_CALLS:
            self._emit(node, "det-clock",
                       f"wall-clock read {name}() in scheduler code — "
                       "use the event loop's virtual clock")
        elif name == "os.getenv":
            self._emit(node, "det-env",
                       "os.getenv in scheduler code — pass "
                       "configuration through constructors")
        elif name is not None:
            self._check_rng(node, name)
        if isinstance(f, ast.Name) and f.id in ("min", "max", "sorted"):
            self._check_order_call(node, f.id)
        if isinstance(f, ast.Name) and f.id == "next" and node.args:
            inner = node.args[0]
            if isinstance(inner, ast.Call) and \
                    isinstance(inner.func, ast.Name) and \
                    inner.func.id == "iter" and inner.args and \
                    self._unordered(inner.args[0]):
                self._emit(node, "det-set-order",
                           "next(iter(<set>)) picks a hash-order-"
                           "dependent element — sort or track an "
                           "explicit index")
        if isinstance(f, ast.Attribute) and f.attr == "pop" and \
                not node.args and not node.keywords and \
                self._unordered(f.value):
            self._emit(node, "det-set-order",
                       "set.pop() removes a hash-order-dependent "
                       "element — pop from a sorted or indexed "
                       "structure instead")
        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, name: str) -> None:
        parts = name.split(".")
        if parts[0] == "random" and len(parts) == 2:
            if parts[1] in _RANDOM_FUNCS:
                self._emit(node, "det-rng",
                           f"module-global {name}() shares one "
                           "process-wide stream — use a seeded "
                           "random.Random instance")
            elif parts[1] in _RNG_CTORS and not node.args \
                    and not node.keywords:
                self._emit(node, "det-rng",
                           f"unseeded {name}() draws entropy from the "
                           "OS — pass an explicit seed")
        elif parts[0] in ("np", "numpy") and len(parts) >= 3 \
                and parts[1] == "random":
            leaf = parts[-1]
            if leaf in _RNG_CTORS:
                if not node.args and not node.keywords:
                    self._emit(node, "det-rng",
                               f"unseeded {name}() — pass an explicit "
                               "seed")
            else:
                self._emit(node, "det-rng",
                           f"global-state {name}() — use a seeded "
                           "np.random.RandomState/default_rng "
                           "instance")
        elif isinstance(node.func, ast.Name) and \
                node.func.id in ("Random", "RandomState") and \
                not node.args and not node.keywords:
            self._emit(node, "det-rng",
                       f"unseeded {node.func.id}() — pass an explicit "
                       "seed")

    @staticmethod
    def _total_order_key(kw: ast.expr) -> bool:
        """A key proves a total order when it ends with the bare element
        itself: ``key=lambda s: s`` or ``key=lambda s: (f(s), s)`` —
        distinct elements then never tie."""
        if not isinstance(kw, ast.Lambda) or len(kw.args.args) != 1:
            return False
        p = kw.args.args[0].arg
        body = kw.body
        if isinstance(body, ast.Name) and body.id == p:
            return True
        return (isinstance(body, ast.Tuple) and body.elts
                and isinstance(body.elts[-1], ast.Name)
                and body.elts[-1].id == p)

    def _check_order_call(self, node: ast.Call, fname: str) -> None:
        if not node.args or not self._unordered(node.args[0]):
            return
        key = next((kw.value for kw in node.keywords
                    if kw.arg == "key"), None)
        if key is None:
            return      # direct element comparison over distinct keys
        if self._total_order_key(key):
            return
        self._emit(node, "det-set-order",
                   f"{fname}() over a set with a key that is not a "
                   "provable total order — ties resolve by hash "
                   "iteration order; append the element itself as a "
                   "tie-break: key=lambda s: (..., s)")

    # -- for-loops over unordered iterables ------------------------------
    def visit_For(self, node: ast.For) -> None:
        if self._unordered(node.iter):
            reason = self._order_sensitive_body(node.body)
            if reason is not None:
                self._emit(node, "det-set-order",
                           "iteration over a set "
                           f"{reason} — iterate sorted(...) or prove "
                           "order-independence with a pragma")
        self.generic_visit(node)

    @staticmethod
    def _order_sensitive_body(body: List[ast.stmt]) -> Optional[str]:
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    f = sub.func
                    callee = f.attr if isinstance(f, ast.Attribute) \
                        else f.id if isinstance(f, ast.Name) else None
                    if callee in SINK_CALLS:
                        return (f"dispatches work via {callee}() in "
                                "hash iteration order")
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    tgts = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in tgts:
                        if isinstance(t, (ast.Attribute, ast.Subscript)):
                            return ("mutates shared state in hash "
                                    "iteration order")
        return None

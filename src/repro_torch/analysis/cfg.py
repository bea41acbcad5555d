"""Statement-level control-flow graphs for lifecycle analysis.

One node per *simple* statement; compound statements (``if`` / ``for``
/ ``while`` / ``with`` / ``try``) contribute a header node carrying
only their test/iterator expression — their bodies become separate
nodes, so a resource acquired in a branch is tracked along that branch
alone.  Two virtual exits: ``EXIT`` (fall-through / ``return``) and
``RAISE`` (``raise``).  Leak analysis treats ``raise`` as a non-leak
exit: crashing on a violated invariant is the intended behaviour of
guard code, not an escaped resource.

The graph is deliberately conservative where Python is dynamic:

  * every statement inside a ``try`` body may jump to each handler
    (any expression can raise), and ``finally`` runs on all paths;
  * loop headers branch both into the body and past it (zero
    iterations), and the body loops back to the header;
  * ``break`` / ``continue`` target the innermost enclosing loop.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

EXIT = -1
RAISE = -2


@dataclasses.dataclass
class Node:
    """One CFG node: the statement it came from plus the AST fragments
    that execute *at* this node (header nodes scan only their
    test/iter, not their bodies)."""
    node_id: int
    stmt: ast.stmt
    frags: List[ast.AST]

    @property
    def line(self) -> int:
        return self.stmt.lineno


@dataclasses.dataclass
class _LoopCtx:
    break_to: Set[int]
    continue_to: Set[int]


class CFG:
    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.nodes: Dict[int, Node] = {}
        self.succ: Dict[int, Set[int]] = {}
        self._next_id = 0
        self.entry: Set[int] = self._seq(list(fn.body), {EXIT}, None)

    # -- construction ---------------------------------------------------
    def _new(self, stmt: ast.stmt, frags: List[ast.AST],
             succ: Set[int]) -> int:
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = Node(nid, stmt, frags)
        self.succ[nid] = set(succ)
        return nid

    def _seq(self, stmts: List[ast.stmt], follow: Set[int],
             loop: Optional[_LoopCtx]) -> Set[int]:
        """Wire ``stmts`` so the last one continues to ``follow``;
        returns the entry set.  Built back-to-front so each statement
        already knows its successor."""
        entry = set(follow)
        for stmt in reversed(stmts):
            entry = self._stmt(stmt, entry, loop)
        return entry

    def _stmt(self, stmt: ast.stmt, follow: Set[int],
              loop: Optional[_LoopCtx]) -> Set[int]:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            tgt = {RAISE} if isinstance(stmt, ast.Raise) else {EXIT}
            return {self._new(stmt, [stmt], tgt)}
        if isinstance(stmt, ast.Break):
            return {self._new(stmt, [], set(loop.break_to) if loop
                              else {EXIT})}
        if isinstance(stmt, ast.Continue):
            return {self._new(stmt, [], set(loop.continue_to) if loop
                              else {EXIT})}
        if isinstance(stmt, ast.If):
            body = self._seq(stmt.body, follow, loop)
            orelse = self._seq(stmt.orelse, follow, loop) \
                if stmt.orelse else set(follow)
            return {self._new(stmt, [stmt.test], body | orelse)}
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            frag = stmt.test if isinstance(stmt, ast.While) \
                else stmt.iter
            head = self._new(stmt, [frag], set(follow))
            inner = _LoopCtx(break_to=set(follow), continue_to={head})
            body = self._seq(stmt.body, {head}, inner)
            self.succ[head] |= body
            if stmt.orelse:
                self.succ[head] |= self._seq(stmt.orelse, follow, loop)
            return {head}
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            body = self._seq(stmt.body, follow, loop)
            return {self._new(stmt, list(stmt.items), body)}
        if isinstance(stmt, ast.Try):
            fin_entry = self._seq(stmt.finalbody, follow, loop) \
                if stmt.finalbody else set(follow)
            handler_entries: Set[int] = set()
            for h in stmt.handlers:
                handler_entries |= self._seq(h.body, fin_entry, loop)
            mark = self._next_id
            body = self._seq(stmt.body + stmt.orelse, fin_entry, loop)
            # any statement in the protected region may divert to a
            # handler mid-flight
            for nid in range(mark, self._next_id):
                self.succ[nid] |= handler_entries
            return body
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # nested definition: executing the def itself acquires
            # nothing; its body is analyzed as its own CFG by callers
            return {self._new(stmt, [], follow)}
        return {self._new(stmt, [stmt], follow)}

    # -- queries --------------------------------------------------------
    def reaches_exit(self, start: int,
                     barriers: Set[int]) -> Optional[Tuple[int, ...]]:
        """Is ``EXIT`` reachable from ``start``'s successors without
        passing through a barrier node?  Returns one witness path of
        node ids (excluding EXIT) or None.  ``RAISE`` does not count as
        an exit."""
        seen: Set[int] = set()
        stack: List[Tuple[int, Tuple[int, ...]]] = [
            (n, ()) for n in sorted(self.succ.get(start, ()))]
        while stack:
            nid, path = stack.pop()
            if nid == EXIT:
                return path
            if nid in (RAISE,) or nid in seen or nid in barriers:
                continue
            seen.add(nid)
            for nxt in sorted(self.succ.get(nid, ())):
                stack.append((nxt, path + (nid,)))
        return None

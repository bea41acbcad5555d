"""Agent Execution Graphs (paper §3.2) + pattern inference (§3.3).

Definition 1: G = (V, E, P, phi) — nodes are LLM inference steps, edges
carry transition probabilities, phi maps each node to a tool type.

Three observability tiers (§3.3):
  (a) explicit — the framework hands us the AEG at task admission
      (``AEG.linear_chain`` / ``AEG.from_edges``);
  (b) implicit — ``PatternInferencer`` learns tool-type transition
      probabilities from completed traces, keeping edges with
      P >= theta_conf (default 0.7);
  (c) cold-start — until ``min_tasks`` traces are seen the inferencer
      reports no AEG and the scheduler falls back to request-level
      behaviour.

``overlap`` implements Eq. 5: for linear ReAct chains the successor's
prompt is the full current context plus the tool observation, so
overlap = n_cur / (n_cur + E[n_obs]) with per-tool observation-length
EMAs (``ToolStats``).
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

TERMINAL = "__finish__"


@dataclass
class AEGNode:
    node_id: int
    tool: str                       # phi(v): tool type of the step
    succs: List[Tuple[int, float]] = field(default_factory=list)


class ToolStats:
    """Per-tool-type EMAs of observation length and tool latency."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.obs_len: Dict[str, float] = {}
        self.latency_hist: Dict[str, List[float]] = defaultdict(list)

    def observe(self, tool: str, obs_tokens: int, latency_s: float,
                max_hist: int = 4096) -> None:
        prev = self.obs_len.get(tool)
        self.obs_len[tool] = (obs_tokens if prev is None
                              else (1 - self.alpha) * prev +
                              self.alpha * obs_tokens)
        h = self.latency_hist[tool]
        h.append(latency_s)
        if len(h) > max_hist:
            del h[:len(h) - max_hist]

    def expected_obs_len(self, tool: str, default: float = 512.0) -> float:
        return self.obs_len.get(tool, default)


class AEG:
    """Agent Execution Graph with reuse-probability queries (Eq. 4-5)."""

    def __init__(self, nodes: Dict[int, AEGNode], p_term: float = 0.03):
        self.nodes = nodes
        self.p_term = p_term

    # -- constructors ---------------------------------------------------
    @classmethod
    def linear_chain(cls, tools: Sequence[str], p_term: float = 0.03,
                     retry_probs: Optional[Dict[int, float]] = None) -> "AEG":
        """ReAct chain: v_i -> v_{i+1} with P = 1 - p_term; optional
        backward retry edges (Fig. 3's coral edges)."""
        nodes = {}
        n = len(tools)
        for i, t in enumerate(tools):
            succs: List[Tuple[int, float]] = []
            retry = (retry_probs or {}).get(i, 0.0)
            if i + 1 < n:
                succs.append((i + 1, (1.0 - p_term) * (1.0 - retry)))
            if retry > 0 and i > 0:
                succs.append((i - 1, (1.0 - p_term) * retry))
            nodes[i] = AEGNode(i, t, succs)
        return cls(nodes, p_term)

    @classmethod
    def from_edges(cls, tools: Dict[int, str],
                   edges: Sequence[Tuple[int, int, float]],
                   p_term: float = 0.03) -> "AEG":
        nodes = {i: AEGNode(i, t) for i, t in tools.items()}
        for u, v, p in edges:
            nodes[u].succs.append((v, p))
        return cls(nodes, p_term)

    # -- queries ----------------------------------------------------------
    def successors(self, node_id: int) -> List[Tuple[int, float]]:
        node = self.nodes.get(node_id)
        return list(node.succs) if node else []

    def most_likely_successor(self, node_id: int) -> Optional[int]:
        succs = self.successors(node_id)
        if not succs:
            return None
        return max(succs, key=lambda sp: sp[1])[0]

    def overlap(self, n_current_tokens: float, succ_node: int,
                stats: ToolStats) -> float:
        """Eq. 5 for linear ReAct chains: the successor prompt is the full
        current context + the expected tool observation."""
        node = self.nodes.get(succ_node)
        tool = node.tool if node else "unknown"
        n_obs = stats.expected_obs_len(tool)
        if n_current_tokens <= 0:
            return 0.0
        return n_current_tokens / (n_current_tokens + max(n_obs, 0.0))

    def p_reuse(self, node_id: int, n_current_tokens: float,
                stats: ToolStats) -> float:
        """Eq. 4: sum over successors of P(v->u) * overlap(s, u)."""
        total = 0.0
        for u, p in self.successors(node_id):
            total += p * self.overlap(n_current_tokens, u, stats)
        return min(1.0, total)

    def work_remaining_steps(self, node_id: int, horizon: int = 256) -> float:
        """Expected number of remaining LLM steps from node_id (used by
        AFS Eq. 9).  Follows max-prob successors, discounting by edge
        probability mass, up to `horizon`."""
        steps = 0.0
        mass = 1.0
        cur = node_id
        seen = 0
        while mass > 1e-3 and seen < horizon:
            succs = self.successors(cur)
            if not succs:
                break
            u, p = max(succs, key=lambda sp: sp[1])
            cont = sum(pp for _, pp in succs)
            steps += mass * cont
            mass *= cont
            cur = u
            seen += 1
        return steps


class PatternInferencer:
    """Tier (b): infer tool-type transition structure from request
    streams (§3.3).

    Nodes are tool types (a first-order Markov abstraction of the step
    graph); an edge survives if its conditional probability exceeds
    theta_conf OR it is the argmax next-type (so prediction is always
    possible once warm).  Cold-start (tier c): below ``min_tasks``
    completed traces, ``infer()`` returns None.
    """

    def __init__(self, theta_conf: float = 0.7, min_tasks: int = 30):
        self.theta_conf = theta_conf
        self.min_tasks = min_tasks
        self.counts: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        self.n_tasks = 0

    def record_trace(self, tools: Sequence[str]) -> None:
        self.n_tasks += 1
        seq = list(tools) + [TERMINAL]
        for a, b in zip(seq[:-1], seq[1:]):
            self.counts[a][b] += 1

    @property
    def warm(self) -> bool:
        return self.n_tasks >= self.min_tasks

    def transition_probs(self, tool: str) -> Dict[str, float]:
        nxt = self.counts.get(tool)
        if not nxt:
            return {}
        tot = sum(nxt.values())
        return {b: c / tot for b, c in nxt.items()}

    def predict_next(self, tool: str) -> Optional[str]:
        probs = self.transition_probs(tool)
        if not probs:
            return None
        best, p = max(probs.items(), key=lambda kv: kv[1])
        return best if best != TERMINAL else None

    def accuracy(self, traces: Sequence[Sequence[str]]) -> float:
        """Fraction of correctly predicted next-step transitions on
        held-out traces (Table 5's 'AEG Accuracy')."""
        hit = tot = 0
        for tr in traces:
            seq = list(tr) + [TERMINAL]
            for a, b in zip(seq[:-1], seq[1:]):
                probs = self.transition_probs(a)
                if not probs:
                    continue
                pred = max(probs.items(), key=lambda kv: kv[1])[0]
                hit += int(pred == b)
                tot += 1
        return hit / tot if tot else 0.0

    def infer(self, current_tool: str, n_more: int = 8,
              p_term_default: float = 0.05) -> Optional[AEG]:
        """Build a lookahead AEG rooted at the session's current tool.

        Returns None during cold-start (tier c fallback to request-level
        scheduling, costing at most ~8% TCT on the first min_tasks tasks
        per the paper).
        """
        if not self.warm:
            return None
        nodes: Dict[int, AEGNode] = {}
        tools: Dict[int, str] = {0: current_tool}
        cur = current_tool
        edges: List[Tuple[int, int, float]] = []
        for i in range(n_more):
            probs = self.transition_probs(cur)
            if not probs:
                break
            best, p = max(probs.items(), key=lambda kv: kv[1])
            keep = {b: q for b, q in probs.items()
                    if q >= self.theta_conf or b == best}
            if best == TERMINAL:
                break
            p_go = keep.get(best, p)
            tools[i + 1] = best
            edges.append((i, i + 1, p_go))
            cur = best
        return AEG.from_edges(tools, edges, p_term=p_term_default)

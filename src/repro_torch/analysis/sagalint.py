"""sagalint driver: file walking, pragma suppression, scoping, CLI.

Usage::

    python -m repro_torch.analysis.sagalint src/repro_torch        # lint the tree
    python -m repro_torch.analysis.sagalint --list-rules

Exit status 0 when no unsuppressed findings, 1 otherwise; diagnostics
are ``path:line:col: rule: message`` lines on stdout.

Scoping: determinism rules assume scheduler code, where byte-identical
replay is contractual.  Files inside a ``repro_torch`` package are therefore
only determinism-checked under the scheduler subpackages (``core`` /
``cluster`` / ``serving`` / ``workflow``); ``train``, ``launch``,
``kernels``, ``models`` etc. legitimately read clocks or environment.
Files *outside* a ``repro_torch`` package (test fixtures, scratch trees) get
every rule.  Lifecycle rules run everywhere — they only trigger on the
repo's own acquire/release vocabulary.

Suppression: ``# sagalint: ok(<rule>[, <rule>...]) <reason>`` on the
offending line, or alone on the line above.  The reason is mandatory —
a pragma without one, and a pragma that suppresses nothing, are
themselves findings (``pragma`` / ``pragma-unused``), so suppressions
stay explained and alive.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import io
import re
import sys
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

SCHED_PKGS = {"core", "cluster", "obs", "serving", "workflow"}

# Scoped rule exemptions (configuration, not pragmas): subpackages whose
# CHARTER exempts them from specific rules.  serving/frontend is the
# wall-clock asyncio driver + HTTP proxy — reading real time is its job,
# so det-clock is off THERE AND ONLY THERE; every other determinism and
# lifecycle rule still applies.  Keys are "/"-joined path suffixes under
# the repro_torch package.
SCOPE_EXEMPT: Dict[str, frozenset] = {
    "serving/frontend": frozenset({"det-clock"}),
}

RULES: Dict[str, str] = {
    "det-hash": "builtin hash() on non-ints (use the FNV-1a helpers)",
    "det-set-order": "set/dict.keys() iteration order escaping into an "
                     "ordering-sensitive sink",
    "det-clock": "wall-clock reads in scheduler code",
    "det-rng": "module-global or unseeded RNG",
    "det-env": "os.environ / os.getenv reads in scheduler code",
    "life-leak": "CFG path acquiring a tracked resource without "
                 "release or handoff",
    "life-guard": "_on_* event handler ignoring its attempt/generation "
                  "stamp",
    "life-span": "CFG path with a tracer.begin(...) that reaches exit "
                 "without tracer.end(...) or handoff",
    "pragma": "malformed suppression pragma (missing reason)",
    "pragma-unused": "pragma that suppresses nothing",
    "parse-error": "file does not parse",
}

_PRAGMA_RE = re.compile(r"#\s*sagalint:\s*ok\(([^)]*)\)\s*(.*)$")


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"{self.rule}: {self.message}"


@dataclasses.dataclass
class _Pragma:
    line: int
    rules: Tuple[str, ...]
    reason: str
    standalone: bool            # comment-only line: applies to line+1
    used: bool = False

    def covers(self, line: int) -> bool:
        return line == self.line or (self.standalone
                                     and line == self.line + 1)


def _comments(source: str) -> List[Tuple[int, str, bool]]:
    """(line, comment_text, standalone) for every real COMMENT token —
    tokenizing (rather than line-scanning) keeps pragma syntax inside
    string literals and docstrings inert."""
    out: List[Tuple[int, str, bool]] = []
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string,
                            tok.start[1] == 0
                            or not tok.line[:tok.start[1]].strip()))
    except (tokenize.TokenError, IndentationError):
        pass                  # ast.parse already reported the file
    return out


def _parse_pragmas(source: str, path: str,
                   findings: List[Finding]) -> List[_Pragma]:
    pragmas: List[_Pragma] = []
    for i, text, standalone in _comments(source):
        m = _PRAGMA_RE.search(text)
        if m is None:
            if "sagalint:" in text:
                findings.append(Finding(
                    path, i, 0, "pragma",
                    "unparseable sagalint pragma — expected "
                    "'# sagalint: ok(<rule>) <reason>'"))
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",")
                      if r.strip())
        reason = m.group(2).strip()
        bad = [r for r in rules if r not in RULES]
        if bad:
            findings.append(Finding(
                path, i, 0, "pragma",
                f"pragma names unknown rule(s) {bad} — known: "
                f"{sorted(RULES)}"))
        if not reason:
            findings.append(Finding(
                path, i, 0, "pragma",
                "pragma without a reason — say why the flagged "
                "construct is safe"))
        pragmas.append(_Pragma(i, rules, reason, standalone))
    return pragmas


def _determinism_in_scope(path: Path) -> bool:
    parts = path.resolve().parts
    if "repro_torch" not in parts:
        return True                    # fixtures etc.: all rules apply
    i = len(parts) - 1 - tuple(reversed(parts)).index("repro_torch")
    return i + 1 < len(parts) - 1 and parts[i + 1] in SCHED_PKGS


def _scope_exempt_rules(path: Path) -> frozenset:
    """Rules switched off for this file by SCOPE_EXEMPT configuration."""
    parts = path.resolve().parts
    if "repro_torch" not in parts:
        return frozenset()
    i = len(parts) - 1 - tuple(reversed(parts)).index("repro_torch")
    rel = "/".join(parts[i + 1:-1])           # package dirs under repro_torch
    out: frozenset = frozenset()
    for scope, rules in SCOPE_EXEMPT.items():
        if rel == scope or rel.startswith(scope + "/"):
            out = out | rules
    return out


def lint_file(path: Path) -> List[Finding]:
    # imported here: these modules import Finding from us
    from repro_torch.analysis.determinism import DeterminismChecker
    from repro_torch.analysis.lifecycle import LifecycleChecker

    pstr = str(path)
    findings: List[Finding] = []
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=pstr)
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        return [Finding(pstr, getattr(e, "lineno", 0) or 0, 0,
                        "parse-error", str(e))]
    pragmas = _parse_pragmas(source, pstr, findings)

    raw: List[Finding] = []
    exempt = _scope_exempt_rules(path)
    if _determinism_in_scope(path):
        det = DeterminismChecker(pstr)
        det.visit(tree)
        raw.extend(f for f in det.findings if f.rule not in exempt)
    life = LifecycleChecker(pstr)
    life.run(tree)
    raw.extend(life.findings)

    seen = set()
    for f in raw:
        key = (f.line, f.col, f.rule, f.message)
        if key in seen:
            continue
        seen.add(key)
        suppressed = False
        for p in pragmas:
            if f.rule in p.rules and p.covers(f.line) and p.reason:
                p.used = True
                suppressed = True
                break
        if not suppressed:
            findings.append(f)
    for p in pragmas:
        if p.reason and not p.used and \
                all(r in RULES for r in p.rules):
            findings.append(Finding(
                pstr, p.line, 0, "pragma-unused",
                f"pragma ok({', '.join(p.rules)}) suppresses nothing "
                "— the finding moved or was fixed; delete the pragma"))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _iter_files(paths: Sequence[str]) -> Iterable[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(q for q in path.rglob("*.py")
                              if "__pycache__" not in q.parts)
        else:
            yield path


def lint_paths(paths: Sequence[str]) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    n = 0
    for f in _iter_files(paths):
        n += 1
        findings.extend(lint_file(f))
    return findings, n


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sagalint",
        description="determinism + resource-lifecycle linter for the "
                    "SAGA scheduler tree")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to lint")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, doc in sorted(RULES.items()):
            print(f"{rule:15s} {doc}")
        return 0
    if not args.paths:
        ap.error("no paths given")
    findings, n_files = lint_paths(args.paths)
    for f in findings:
        print(f.render())
    print(f"sagalint: {len(findings)} finding(s) in {n_files} "
          f"file(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())

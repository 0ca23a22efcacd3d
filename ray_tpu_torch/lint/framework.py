"""Check framework: file walking, import-alias resolution, inline
suppressions, the baseline protocol, and the check registry.

A check subclasses `Check` and yields `Finding`s from `visit_module`
(per file) and/or `finalize` (after all files — program-wide checks
like the lock-order graph use this).  Checks never see suppressed
lines: suppression and sorting are applied by `lint_paths`.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import time
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".eggs", "build"}


# ----------------------------------------------------------------------
# findings
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # posix, relative to the lint root
    line: int
    col: int
    message: str

    @property
    def key(self) -> str:
        """Baseline identity: line numbers churn, (path, rule) counts
        don't — a grandfathered count can only shrink."""
        return f"{self.path}::{self.rule}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


# ----------------------------------------------------------------------
# per-module context handed to checks
# ----------------------------------------------------------------------
class ModuleInfo:
    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path  # posix relative path
        self.source = source
        self.tree = tree
        self.aliases = _import_aliases(tree)
        # dotted import path of this module ("ray_tpu_torch/core/retry.py" ->
        # "ray_tpu_torch.core.retry"); the interprocedural pass keys its
        # project-wide function table on it
        self.dotted = (
            path.removesuffix(".py").removesuffix("/__init__")
            .replace("/", ".")
        )

    def canonical(self, node: ast.AST) -> str:
        """Dotted name of a Name/Attribute expr with the first segment
        resolved through this module's import aliases; '' when the
        expression has no static dotted form (subscripts, calls, ...).

        Matching is import-gated: `time.sleep` only canonicalizes to
        the stdlib name if the module actually imported `time`, so a
        local variable that happens to be called `time` cannot trip a
        rule."""
        dotted = _dotted(node)
        if not dotted:
            return ""
        head, _, rest = dotted.partition(".")
        mapped = self.aliases.get(head)
        if mapped is None:
            return dotted
        return f"{mapped}.{rest}" if rest else mapped

def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """local name -> canonical dotted origin, for every import in the
    file (any depth — function-local imports are idiomatic here)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    # `import a.b` binds `a`
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative import: no stable canonical form
                continue
            mod = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{mod}.{a.name}" if mod else a.name
    return out


def shallow_walk(body: Sequence[ast.AST]) -> Iterable[ast.AST]:
    """Walk statements/expressions without crossing into nested
    function definitions or lambdas (their bodies execute in a
    different context — possibly an executor thread), but descending
    into everything else."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue  # yielded, but its body belongs to another context
        stack.extend(ast.iter_child_nodes(node))


# ----------------------------------------------------------------------
# check registry
# ----------------------------------------------------------------------
class Check:
    rule: str = "RT000"
    name: str = ""
    description: str = ""
    #: lint root (absolute path); set by `lint_paths` before any visit
    #: so checks that consult non-Python project files (docs/ knob
    #: tables, the baseline) resolve them against the tree under lint.
    root: str = ""

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        return ()

    def visit_project(self, mods: Sequence[ModuleInfo]) -> Iterable[Finding]:
        """Called once after every module's `visit_module`, with ALL
        parsed modules — the interprocedural checks (call graph,
        catalog drift) do their whole-program reasoning here."""
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()


_REGISTRY: List[type] = []


def register(cls: type) -> type:
    _REGISTRY.append(cls)
    return cls


def rule_catalog() -> List[Tuple[str, str, str]]:
    _load_checks()
    return sorted(
        (c.rule, c.name, c.description.strip()) for c in _REGISTRY
    )


def _load_checks() -> None:
    if not _REGISTRY:
        from ray_tpu_torch.lint import checks  # noqa: F401  (registers on import)
        from ray_tpu_torch.lint import concurrency  # noqa: F401  (RT009-RT013)


# ----------------------------------------------------------------------
# suppressions
# ----------------------------------------------------------------------
_SUPPRESS_RE = re.compile(
    r"rtlint:\s*(disable(?:-file)?)\s*(?:=\s*([A-Z0-9,\s]+))?"
)


def _suppressions(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """-> ({line: rules-or-{'*'}}, file-wide rules-or-{'*'}).

    Comments are located with tokenize so strings that merely contain
    'rtlint:' can't suppress anything; on tokenize failure (the file
    already gets an RT000 parse finding) nothing is suppressed."""
    per_line: Dict[int, Set[str]] = {}
    per_file: Set[str] = set()
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return per_line, per_file
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        kind, rules_s = m.group(1), m.group(2)
        rules = (
            {r.strip() for r in rules_s.split(",") if r.strip()}
            if rules_s
            else {"*"}
        )
        if kind == "disable-file":
            per_file |= rules
        else:
            per_line.setdefault(tok.start[0], set()).update(rules)
    return per_line, per_file


def _suppressed(
    f: Finding, per_line: Dict[int, Set[str]], per_file: Set[str]
) -> bool:
    for rules in (per_file, per_line.get(f.line, set())):
        if "*" in rules or f.rule in rules:
            return True
    return False


# ----------------------------------------------------------------------
# runner
# ----------------------------------------------------------------------
def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in _SKIP_DIRS
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def lint_paths(
    paths: Sequence[str],
    *,
    select: Optional[Set[str]] = None,
    root: Optional[str] = None,
    stats: Optional[Dict[str, Dict[str, float]]] = None,
) -> List[Finding]:
    """Run every registered check over `paths`; findings come back
    suppression-filtered and sorted.  `root` anchors the relative paths
    findings carry (default: the repo root).  Passing a dict as `stats`
    fills it with per-rule accounting: {rule: {"findings": n,
    "seconds": wall}} plus a "_total" row (the `--stats` CLI view and
    the tier-1 interprocedural-pass time budget read it)."""
    _load_checks()
    root = os.path.abspath(root or _REPO_ROOT)
    checks = [cls() for cls in _REGISTRY]
    if select:
        checks = [c for c in checks if c.rule in select]
    t_start = time.perf_counter()
    spent: Dict[str, float] = {c.rule: 0.0 for c in checks}
    for check in checks:
        check.root = root
    raw: List[Finding] = []
    sup: Dict[str, Tuple[Dict[int, Set[str]], Set[str]]] = {}
    mods: List[ModuleInfo] = []
    for abspath in iter_py_files([os.path.abspath(p) for p in paths]):
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        if rel.startswith("../"):  # outside the root: keep it readable
            rel = abspath.replace(os.sep, "/")
        try:
            with open(abspath, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=abspath)
        except (SyntaxError, ValueError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 1) or 1
            raw.append(Finding("RT000", rel, line, 0, f"parse error: {e}"))
            continue
        sup[rel] = _suppressions(source)
        mod = ModuleInfo(rel, source, tree)
        mods.append(mod)
        for check in checks:
            t0 = time.perf_counter()
            raw.extend(check.visit_module(mod))
            spent[check.rule] += time.perf_counter() - t0
    for check in checks:
        t0 = time.perf_counter()
        raw.extend(check.visit_project(mods))
        raw.extend(check.finalize())
        spent[check.rule] += time.perf_counter() - t0
    out = [
        f
        for f in raw
        if f.path not in sup or not _suppressed(f, *sup[f.path])
    ]
    out = sorted(set(out), key=lambda f: (f.path, f.line, f.col, f.rule))
    if stats is not None:
        per_rule: Dict[str, int] = {}
        for f in out:
            per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
        for check in checks:
            stats[check.rule] = {
                "findings": float(per_rule.get(check.rule, 0)),
                "seconds": spent[check.rule],
            }
        stats["_total"] = {
            "findings": float(len(out)),
            "seconds": time.perf_counter() - t_start,
        }
    return out


# ----------------------------------------------------------------------
# baseline protocol
# ----------------------------------------------------------------------
def default_baseline_path() -> str:
    """The port's own baseline, beside this package: the JAX package's
    `lint_baseline.json` at the repo root grandfathers its tree only."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.json")


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    return {k: int(v) for k, v in doc.get("counts", {}).items()}


def render_baseline(findings: Sequence[Finding]) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        if f.rule == "RT000":
            # a parse error can never be grandfathered: an unparseable
            # file receives zero invariant checking, so baselining it
            # would make tier-1 pass on a file the linter cannot read
            continue
        counts[f.key] = counts.get(f.key, 0) + 1
    doc = {
        "_comment": (
            "Grandfathered rtlint findings, keyed by 'path::rule' with "
            "counts. Regenerate (only ever shrinking it) with: "
            "python -m ray_tpu_torch.lint --write-baseline"
        ),
        "version": 1,
        "counts": {k: counts[k] for k in sorted(counts)},
    }
    return json.dumps(doc, indent=2) + "\n"


def compare_to_baseline(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> Tuple[List[Finding], Dict[str, Tuple[int, int]]]:
    """-> (new_findings, shrunk).

    A (path, rule) bucket that grew past its grandfathered count
    surfaces ALL its findings (line churn makes 'which one is new'
    unknowable); `shrunk` maps keys whose live count dropped below the
    baseline (current, baselined) so callers can prompt a regen."""
    by_key: Dict[str, List[Finding]] = {}
    for f in findings:
        by_key.setdefault(f.key, []).append(f)
    new: List[Finding] = []
    shrunk: Dict[str, Tuple[int, int]] = {}
    for key, fs in by_key.items():
        allowed = baseline.get(key, 0)
        if len(fs) > allowed:
            new.extend(fs)
        elif len(fs) < allowed:
            shrunk[key] = (len(fs), allowed)
    for key, allowed in baseline.items():
        if allowed and key not in by_key:
            shrunk[key] = (0, allowed)
    return sorted(new, key=lambda f: (f.path, f.line, f.rule)), shrunk

"""Interprocedural concurrency rules (RT009–RT013).

The RT001–RT008 rules are intraprocedural: they judge one function (or
one file) at a time.  The bug classes the last six PRs' review passes
hand-caught are NOT visible at that granularity — a sync helper that
blocks is fine until an `async def` three call-edges away starts
calling it; a deadline timer is armed in one method and (not) cancelled
in another; a metric name drifts from the catalog in a different file.
These checks therefore run over a *project call graph*: every linted
module's functions, indexed by dotted qualified name, with call edges
resolved through import aliases and `self.`-method dispatch.

Resolution is deliberately conservative (a call that cannot be
statically resolved simply creates no edge), so every finding is backed
by a concrete chain the message spells out.  The graph is built once
per lint run and shared by all five rules.

Rules:
  RT009 blocking-reachable-from-async — RT001 across function
        boundaries: an `async def` calls a sync function whose
        transitive sync call closure hits a known-blocking call.
  RT010 resource-lifecycle — acquire without release along any path:
        discarded `call_later` handles (the PR-1 un-cancelled deadline
        timer), `start_span` without `finish_span`, `placement_group`
        results that leak, `store.create` without seal/abort, and
        `chan_write_acquire` without a seal in the same function (the
        PR-15 wedged-ring shape).
  RT011 cross-loop-misuse — loop-bound primitives touched from the
        wrong context: `call_soon` from a plain (possibly foreign-
        thread) sync function instead of `call_soon_threadsafe` /
        `rpc.call_on_conn_loop`, and asyncio primitives constructed at
        module/class scope where several loops can bind them.
  RT012 unawaited-coroutine — a call that resolves to an `async def`
        used as a bare statement or truth-tested (always-true), so it
        never runs (the PR-6 class).
  RT013 catalog-drift — literal metric names at instrumentation sites
        and in grafana panel expressions must exist in
        `metrics/metric_defs.py`'s CATALOG (and catalog entries must be
        referenced somewhere); `Config` knobs must appear in the docs/
        knob tables.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.lint.checks import _last_segment, blocking_label
from ray_tpu_torch.lint.framework import (
    Check,
    Finding,
    ModuleInfo,
    _suppressions,
    register,
    shallow_walk,
)


# ----------------------------------------------------------------------
# the shared project call graph
# ----------------------------------------------------------------------
@dataclass
class FuncDef:
    qname: str  # dotted module path + qualified name inside the module
    mod: ModuleInfo
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls_qual: Optional[str]  # dotted qname of the enclosing class
    is_async: bool


class ProjectIndex:
    """Function table + call resolution over one lint run's modules.

    Built once and shared: `of(mods)` caches on the identity of the
    module list `lint_paths` hands every check in `visit_project`."""

    _cache: Tuple[Optional[int], Optional["ProjectIndex"]] = (None, None)

    def __init__(self, mods: Sequence[ModuleInfo]):
        self.mods = list(mods)
        self.funcs: List[FuncDef] = []
        self.by_qname: Dict[str, FuncDef] = {}
        self._parents: Dict[str, Dict[ast.AST, ast.AST]] = {}
        for mod in mods:
            self._collect(mod)

    @classmethod
    def of(cls, mods: Sequence[ModuleInfo]) -> "ProjectIndex":
        key, cached = cls._cache
        if cached is not None and key == id(mods) and cached.mods == list(mods):
            return cached
        built = cls(mods)
        cls._cache = (id(mods), built)
        return built

    # -- construction --------------------------------------------------
    def _collect(self, mod: ModuleInfo) -> None:
        def walk(node: ast.AST, quals: List[str], cls_qual: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, quals + [child.name],
                         f"{mod.dotted}." + ".".join(quals + [child.name]))
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    q = f"{mod.dotted}." + ".".join(quals + [child.name])
                    fd = FuncDef(
                        qname=q,
                        mod=mod,
                        node=child,
                        cls_qual=cls_qual,
                        is_async=isinstance(child, ast.AsyncFunctionDef),
                    )
                    self.funcs.append(fd)
                    # latest definition wins (overloads are rare enough
                    # that the ambiguity isn't worth tracking)
                    self.by_qname[q] = fd
                    walk(child, quals + [child.name], cls_qual)
                else:
                    walk(child, quals, cls_qual)

        walk(mod.tree, [], None)

    def parents(self, mod: ModuleInfo) -> Dict[ast.AST, ast.AST]:
        p = self._parents.get(mod.path)
        if p is None:
            p = {}
            for node in ast.walk(mod.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents[mod.path] = p
        return p

    # -- call resolution -----------------------------------------------
    def resolve(self, call: ast.Call, f: FuncDef) -> Optional[FuncDef]:
        """The FuncDef a call statically resolves to, or None.  Only
        unambiguous shapes resolve: local nested defs, module-level
        names, `self./cls.` methods of the enclosing class, and
        imported names whose canonical dotted path names a linted
        function."""
        fn = call.func
        mod = f.mod
        if isinstance(fn, ast.Name):
            name = fn.id
            # nested def in the enclosing function
            hit = self.by_qname.get(f"{f.qname}.{name}")
            if hit is not None:
                return hit
            # module-level function (or a method of the same class for
            # code inside a class body)
            hit = self.by_qname.get(f"{mod.dotted}.{name}")
            if hit is not None:
                return hit
            origin = mod.aliases.get(name)
            if origin:
                return self.by_qname.get(origin)
            return None
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if (
                isinstance(base, ast.Name)
                and base.id in ("self", "cls")
                and f.cls_qual
            ):
                return self.by_qname.get(f"{f.cls_qual}.{fn.attr}")
            cn = mod.canonical(fn)
            if cn:
                return self.by_qname.get(cn)
        return None


# ----------------------------------------------------------------------
@register
class BlockingReachableFromAsync(Check):
    """RT009: RT001 generalized across function boundaries.  An
    `async def` that calls a sync function whose (transitive, sync-only)
    call closure contains a blocking call stalls its event loop exactly
    like the direct case — it's just invisible to single-function
    review.  Traversal crosses SYNC edges only: blocking inside another
    `async def` is that function's own RT001."""

    rule = "RT009"
    name = "blocking-reachable-from-async"
    description = (
        "sync function containing a blocking call (time.sleep, "
        "subprocess, sync IO) transitively called from `async def` — "
        "the whole chain stalls the event loop"
    )

    _MAX_DEPTH = 24

    def visit_project(self, mods: Sequence[ModuleInfo]) -> Iterable[Finding]:
        idx = ProjectIndex.of(mods)
        # direct blocking site per sync function.  A `# rtlint:
        # disable=RT009` ON THE BLOCKING LINE exempts that site for
        # every async caller — the rationale lives once, at the true
        # source, instead of repeating at each of N call sites (the
        # standard suppression at the reported call-site line also
        # works, per finding).
        sup_cache: Dict[str, Tuple[Dict[int, Set[str]], Set[str]]] = {}

        def exempt(mod: ModuleInfo, line: int) -> bool:
            per_line, per_file = sup_cache.setdefault(
                mod.path, _suppressions(mod.source)
            )
            rules = per_file | per_line.get(line, set())
            return "*" in rules or self.rule in rules

        direct: Dict[str, Tuple[str, int]] = {}
        for f in idx.funcs:
            if f.is_async:
                continue
            for sub in shallow_walk(f.node.body):
                if isinstance(sub, ast.Call):
                    label = blocking_label(sub, f.mod)
                    if label and not exempt(f.mod, sub.lineno):
                        direct[f.qname] = (label, sub.lineno)
                        break

        # memoized chain to the nearest blocking call, sync edges only:
        # qname -> [qname, ..., terminal-with-direct-blocking] or None
        memo: Dict[str, Optional[List[str]]] = {}

        def chain_of(q: str, depth: int) -> Optional[List[str]]:
            if q in memo:
                return memo[q]
            memo[q] = None  # cycle guard: a cycle alone never blocks
            if q in direct:
                memo[q] = [q]
                return memo[q]
            if depth >= self._MAX_DEPTH:
                return None
            f = idx.by_qname[q]
            for sub in shallow_walk(f.node.body):
                if not isinstance(sub, ast.Call):
                    continue
                callee = idx.resolve(sub, f)
                if callee is None or callee.is_async:
                    continue
                tail = chain_of(callee.qname, depth + 1)
                if tail is not None:
                    memo[q] = [q] + tail
                    return memo[q]
            return None

        for f in idx.funcs:
            if not f.is_async:
                continue
            for sub in shallow_walk(f.node.body):
                if not isinstance(sub, ast.Call):
                    continue
                callee = idx.resolve(sub, f)
                if callee is None or callee.is_async:
                    continue
                chain = chain_of(callee.qname, 0)
                if chain is None:
                    continue
                label, line = direct[chain[-1]]
                term = idx.by_qname[chain[-1]]
                hops = " -> ".join(
                    q.rsplit(".", 1)[-1] for q in chain[:4]
                ) + (" -> ..." if len(chain) > 4 else "")
                yield Finding(
                    self.rule,
                    f.mod.path,
                    sub.lineno,
                    sub.col_offset,
                    f"`async def {f.node.name}` reaches blocking "
                    f"{label} through sync call chain {hops} "
                    f"({term.mod.path}:{line}) — the whole chain runs "
                    "on the event loop; run_in_executor the entry call "
                    "or make the chain async",
                )


# ----------------------------------------------------------------------
# RT010 resource lifecycle
# ----------------------------------------------------------------------
# acquire shapes.  token: how the resource is named afterwards —
#   "result"  the call's return value (timer handle, span record, PG)
#   "arg0"    the call's first positional arg (store.create's key)
#   None      no token; the release must simply appear in the function
_LIFECYCLES = [
    {
        "key": "timer",
        "attr": {"call_later", "call_at"},
        "token": "result",
        "release_methods": {"cancel"},
        "release_calls": set(),
        "what": "timer handle",
        "fix": "keep the handle and cancel() it on every completion "
               "path (an uncancelled watchdog fires into torn-down "
               "state)",
    },
    {
        "key": "span",
        "attr": {"start_span"},
        "token": "result",
        "release_methods": set(),
        "release_calls": {"finish_span"},
        "what": "trace span",
        "fix": "finish_span(span) on every exit (an unfinished span "
               "never exports and leaks its buffer entry)",
    },
    {
        "key": "pg",
        "attr": {"placement_group"},
        "token": "result",
        "release_methods": set(),
        "release_calls": {"remove_placement_group"},
        "what": "placement group",
        "fix": "remove_placement_group(pg) when done (a CREATED PG "
               "pins its bundles forever)",
    },
    {
        "key": "store-create",
        "attr": {"create"},
        "recv_contains": "store",
        "token": "arg0",
        "release_methods": set(),
        # seal publishes, abort/delete reclaim — any of them resolves
        # the ACQUIRED state
        "release_calls": {"seal", "abort", "delete"},
        "what": "created-but-unsealed store object",
        "fix": "seal() it (or abort() on the failure path) before "
               "returning — an unsealed create pins arena and wedges "
               "readers",
    },
]


@register
class ResourceLifecycle(Check):
    """RT010: acquire/release pairing.  Flags the two shapes that are
    provably leaks without path-sensitive analysis: (a) the acquire's
    token is DISCARDED on the spot (`loop.call_later(...)` as a bare
    statement — nobody can ever cancel it), and (b) the token is bound
    to a local that is never released NOR escapes the function (never
    returned/stored/passed on) — it dies unreleased on every path.
    Tokens that escape are some other scope's responsibility; releases
    anywhere in the function (including under `finally`) count."""

    rule = "RT010"
    name = "resource-lifecycle"
    description = (
        "acquired resource never released on any path: discarded "
        "call_later handle, start_span without finish_span, leaked "
        "placement group, store.create without seal/abort, "
        "chan_write_acquire without seal"
    )

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(node, mod)

    # -- per-function --------------------------------------------------
    def _check_function(self, fn, mod: ModuleInfo) -> Iterable[Finding]:
        body = list(shallow_walk(fn.body))
        calls = [n for n in body if isinstance(n, ast.Call)]
        parents: Dict[ast.AST, ast.AST] = {}
        stack = list(fn.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            for c in ast.iter_child_nodes(n):
                parents[c] = n
                stack.append(c)

        # ring slots: acquire and seal are separate native calls; a
        # function that acquires but can't seal wedges the ring
        acquires = [c for c in calls
                    if self._attr_name(c) == "chan_write_acquire"]
        if acquires and not any(
            self._attr_name(c) == "chan_write_seal" for c in calls
        ):
            a = acquires[0]
            yield Finding(
                self.rule, mod.path, a.lineno, a.col_offset,
                "chan_write_acquire without chan_write_seal in "
                f"`{fn.name}` — an acquired-but-unsealed slot wedges "
                "the ring for every later writer; seal (payload or "
                "overflow marker) on every path",
            )

        for call in calls:
            spec = self._match_acquire(call, mod)
            if spec is None:
                continue
            parent = parents.get(call)
            if spec["token"] == "result":
                if isinstance(parent, ast.Expr):
                    yield Finding(
                        self.rule, mod.path, call.lineno, call.col_offset,
                        f"{spec['what']} from "
                        f"{self._label(call)}() is discarded — {spec['fix']}",
                    )
                    continue
                token = self._assigned_name(parent, call)
                if token is None:
                    continue  # escapes immediately (arg, attr, return)
                if not self._released_or_escapes(
                    body, call, token, spec
                ):
                    yield Finding(
                        self.rule, mod.path, call.lineno, call.col_offset,
                        f"{spec['what']} `{token}` is never released "
                        f"and never leaves `{fn.name}` — {spec['fix']}",
                    )
            elif spec["token"] == "arg0":
                if not call.args or not isinstance(call.args[0], ast.Name):
                    continue
                token = call.args[0].id
                released = any(
                    self._attr_name(c) in spec["release_calls"]
                    and any(
                        isinstance(a, ast.Name) and a.id == token
                        for a in c.args
                    )
                    for c in calls
                )
                escapes = self._name_escapes(body, call, token,
                                             spec["release_calls"])
                if not released and not escapes:
                    yield Finding(
                        self.rule, mod.path, call.lineno, call.col_offset,
                        f"{spec['what']} keyed `{token}` in "
                        f"`{fn.name}` — {spec['fix']}",
                    )

    # -- matchers ------------------------------------------------------
    @staticmethod
    def _attr_name(call: ast.Call) -> str:
        return _last_segment(call.func)

    @staticmethod
    def _label(call: ast.Call) -> str:
        return _last_segment(call.func) or "<call>"

    def _match_acquire(self, call: ast.Call, mod: ModuleInfo):
        name = self._attr_name(call)
        for spec in _LIFECYCLES:
            if name not in spec["attr"]:
                continue
            recv_needs = spec.get("recv_contains")
            if recv_needs:
                if not isinstance(call.func, ast.Attribute):
                    continue
                recv = _last_segment(call.func.value).lower()
                if recv_needs not in recv:
                    continue
            elif spec["key"] == "pg":
                # bare-name or imported call only (a `.placement_group`
                # attribute on some object is not the util constructor)
                cn = mod.canonical(call.func)
                if not (cn == "placement_group"
                        or cn.endswith(".placement_group")):
                    continue
            elif spec["key"] == "timer":
                # call_later/call_at live on event loops; require an
                # attribute call so dict.get-style names can't trip it
                if not isinstance(call.func, ast.Attribute):
                    continue
            return spec
        return None

    @staticmethod
    def _assigned_name(parent, call: ast.Call) -> Optional[str]:
        if (
            isinstance(parent, ast.Assign)
            and parent.value is call
            and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)
        ):
            return parent.targets[0].id
        if (
            isinstance(parent, ast.AnnAssign)
            and parent.value is call
            and isinstance(parent.target, ast.Name)
        ):
            return parent.target.id
        return None

    def _released_or_escapes(self, body, acquire, token, spec) -> bool:
        """True when the token is released in this function OR any
        other use reaches it (returned, passed on, stored) — only a
        token that provably dies untouched is a finding."""
        for n in body:
            if isinstance(n, ast.Call):
                # token.cancel()-style release
                if (
                    isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == token
                    and n.func.attr in spec["release_methods"]
                ):
                    return True
                # finish_span(token)-style release
                if self._attr_name(n) in spec["release_calls"] and any(
                    isinstance(a, ast.Name) and a.id == token
                    for a in n.args
                ):
                    return True
        return self._name_escapes(body, acquire, token,
                                  spec["release_calls"],
                                  spec["release_methods"])

    @staticmethod
    def _name_escapes(body, acquire, token, release_calls,
                      release_methods=frozenset()) -> bool:
        """Any Load use of `token` beyond the acquire itself and the
        recognized release shapes — conservative: an escaping token is
        assumed released elsewhere."""
        for n in body:
            if not (isinstance(n, ast.Name) and n.id == token
                    and isinstance(n.ctx, ast.Load)):
                continue
            if any(n is a for a in getattr(acquire, "args", ())):
                continue  # the arg0 position inside the acquire
            return True
        return False


# ----------------------------------------------------------------------
@register
class CrossLoopMisuse(Check):
    """RT011: loop-bound primitives touched from the wrong context.
    `loop.call_soon` from a plain sync function runs on whatever thread
    the caller happens to be — from a foreign thread it enqueues
    without waking the selector, so the callback sits until unrelated
    traffic arrives (the PR-7 hang).  asyncio primitives constructed at
    module/class scope bind to whichever loop first touches them, then
    explode (or silently never wake) when another loop follows."""

    rule = "RT011"
    name = "cross-loop-misuse"
    description = (
        "loop.call_soon from a sync (possibly foreign-thread) function "
        "— use call_soon_threadsafe / rpc.call_on_conn_loop; asyncio "
        "Event/Condition/Queue/Lock constructed at module or class "
        "scope binds to the first loop that touches it"
    )

    _PRIMS = {
        "asyncio.Event",
        "asyncio.Condition",
        "asyncio.Queue",
        "asyncio.Lock",
        "asyncio.Semaphore",
        "asyncio.BoundedSemaphore",
    }
    _SAME_THREAD_LOOP = {"asyncio.get_event_loop",
                         "asyncio.get_running_loop"}

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        yield from self._module_scope_prims(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.FunctionDef):  # sync only
                yield from self._call_soon_in_sync(node, mod)

    def _module_scope_prims(self, mod: ModuleInfo) -> Iterable[Finding]:
        def scan(body) -> Iterable[Finding]:
            for stmt in body:
                if isinstance(stmt, ast.ClassDef):
                    yield from scan(stmt.body)
                    continue
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                value = stmt.value
                if not isinstance(value, ast.Call):
                    continue
                cn = mod.canonical(value.func)
                if cn in self._PRIMS:
                    yield Finding(
                        self.rule, mod.path, value.lineno,
                        value.col_offset,
                        f"{cn}() at module/class scope binds to the "
                        "first event loop that touches it — construct "
                        "it inside the owning loop's context (e.g. in "
                        "the coroutine / loop-thread init)",
                    )

        yield from scan(mod.tree.body)

    def _call_soon_in_sync(self, fn: ast.FunctionDef,
                           mod: ModuleInfo) -> Iterable[Finding]:
        # receivers proven same-thread: `loop = asyncio.get_event_loop()`
        local_loops: Set[str] = set()
        for sub in shallow_walk(fn.body):
            if (
                isinstance(sub, ast.Assign)
                and isinstance(sub.value, ast.Call)
                and mod.canonical(sub.value.func) in self._SAME_THREAD_LOOP
            ):
                local_loops.update(
                    t.id for t in sub.targets if isinstance(t, ast.Name)
                )
        for sub in shallow_walk(fn.body):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "call_soon"
            ):
                continue
            recv = sub.func.value
            if isinstance(recv, ast.Name) and recv.id in local_loops:
                continue
            # only flag receivers that are clearly event loops: a bare
            # `loop`-ish name or an attribute chain ending `.loop`/`._loop`
            last = _last_segment(recv).lower()
            if "loop" not in last:
                continue
            yield Finding(
                self.rule, mod.path, sub.lineno, sub.col_offset,
                f"`{last}.call_soon(...)` inside sync `{fn.name}` — "
                "from a foreign thread this never wakes the selector "
                "(callback sits until unrelated traffic); use "
                "call_soon_threadsafe, or suppress with a rationale if "
                "this function provably runs on that loop",
            )


# ----------------------------------------------------------------------
@register
class UnawaitedCoroutine(Check):
    """RT012: a call whose callee statically resolves to `async def`,
    used where the coroutine object itself is the bug: as a bare
    statement (never runs — the PR-6 class) or in a truth test (a
    coroutine object is always truthy, so the branch is constant AND
    it never runs)."""

    rule = "RT012"
    name = "unawaited-coroutine"
    description = (
        "call resolving to `async def` used as a bare statement or "
        "truth-tested — the coroutine never runs; await it or hand it "
        "to ensure_future/create_task"
    )

    def visit_project(self, mods: Sequence[ModuleInfo]) -> Iterable[Finding]:
        idx = ProjectIndex.of(mods)
        for f in idx.funcs:
            parents = idx.parents(f.mod)
            for sub in shallow_walk(f.node.body):
                if not isinstance(sub, ast.Call):
                    continue
                callee = idx.resolve(sub, f)
                if callee is None or not callee.is_async:
                    continue
                how = self._misused(sub, parents)
                if how is None:
                    continue
                yield Finding(
                    self.rule, f.mod.path, sub.lineno, sub.col_offset,
                    f"coroutine `{callee.node.name}()` (async def at "
                    f"{callee.mod.path}:{callee.node.lineno}) {how} — "
                    "it never executes; await it or wrap in "
                    "asyncio.ensure_future/create_task",
                )

    @staticmethod
    def _misused(call: ast.Call, parents) -> Optional[str]:
        p = parents.get(call)
        if isinstance(p, ast.Expr):
            return "called as a bare statement"
        if isinstance(p, ast.BoolOp) and call in p.values:
            return "used as a boolean operand (always truthy)"
        if isinstance(p, ast.UnaryOp) and isinstance(p.op, ast.Not):
            return "negated (a coroutine object is always truthy)"
        if isinstance(p, (ast.If, ast.While)) and p.test is call:
            return "used as a branch condition (always truthy)"
        if isinstance(p, ast.IfExp) and p.test is call:
            return "used as a conditional-expression test (always truthy)"
        if isinstance(p, ast.Assert) and p.test is call:
            return "asserted (always passes without running)"
        if isinstance(p, ast.comprehension) and call in p.ifs:
            return "used as a comprehension filter (always truthy)"
        return None


# ----------------------------------------------------------------------
@register
class CatalogDrift(Check):
    """RT013: single-source-of-truth catalogs must not drift.  Metric
    names: every literal passed to the `metric_defs` record helpers and
    every `rt_*` token in a grafana panel expression must exist in
    `metrics/metric_defs.py`'s CATALOG (grafana's own `_gauge`
    definitions count), and every CATALOG entry must be referenced
    SOMEWHERE (a renamed metric leaves a dead catalog row and a silent
    dashboard hole).  Config knobs: every `Config` field's `RTT_*` env
    var must appear in the docs/ knob tables."""

    rule = "RT013"
    name = "catalog-drift"
    description = (
        "metric name not in metric_defs.CATALOG (or catalog entry "
        "referenced nowhere), grafana panel referencing an unknown "
        "metric, or Config knob missing from the docs/ knob tables"
    )

    _HELPERS = {
        "ray_tpu_torch.metrics.metric_defs.inc",
        "ray_tpu_torch.metrics.metric_defs.observe",
        "ray_tpu_torch.metrics.metric_defs.set_gauge",
        "ray_tpu_torch.metrics.metric_defs.metric",
    }
    _TOKEN_RE = re.compile(r"\brt_[a-z0-9_]+")
    _SERIES_SUFFIXES = ("_bucket", "_sum", "_count")

    def __init__(self) -> None:
        self._catalog: Dict[str, int] = {}  # name -> def line
        self._catalog_path: Optional[str] = None
        self._uses: List[Tuple[str, int, int, str]] = []  # helper sites
        self._grafana: List[Tuple[str, int, int, str]] = []  # panel tokens
        self._grafana_local: Set[str] = set()
        self._all_literals: Set[str] = set()  # rt_* tokens repo-wide
        self._config_fields: List[Tuple[str, int, str]] = []
        self._config_path: Optional[str] = None
        self._n_runtime_mods = 0

    # -- collection ----------------------------------------------------
    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.path.endswith("metrics/metric_defs.py"):
            self._collect_catalog(mod)
            return ()
        if "ray_tpu_torch/" in f"/{mod.path}":
            self._n_runtime_mods += 1
            self._all_literals.update(self._TOKEN_RE.findall(mod.source))
        if mod.path.endswith("dashboard/grafana.py"):
            self._collect_grafana(mod)
        if mod.path.endswith("core/config.py"):
            self._collect_config(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if mod.canonical(node.func) in self._HELPERS and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    self._uses.append(
                        (mod.path, a0.lineno, a0.col_offset, a0.value)
                    )
        return ()

    def _collect_catalog(self, mod: ModuleInfo) -> None:
        self._catalog_path = mod.path
        for node in mod.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "CATALOG"
                for t in targets
            ):
                continue
            if isinstance(value, ast.Dict):
                for k in value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                        k.value, str
                    ):
                        self._catalog[k.value] = k.lineno

    def _collect_grafana(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and node.args:
                if _last_segment(node.func) in ("_gauge", "Gauge",
                                                "Counter", "Histogram"):
                    a0 = node.args[0]
                    if isinstance(a0, ast.Constant) and isinstance(
                        a0.value, str
                    ):
                        self._grafana_local.add(a0.value)
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                for tok in self._TOKEN_RE.findall(node.value):
                    self._grafana.append(
                        (mod.path, node.lineno, node.col_offset, tok)
                    )

    def _collect_config(self, mod: ModuleInfo) -> None:
        self._config_path = mod.path
        for node in mod.tree.body:
            if not (isinstance(node, ast.ClassDef) and node.name == "Config"):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    name = stmt.target.id
                    self._config_fields.append(
                        (name, stmt.lineno, f"RTT_{name.upper()}")
                    )

    # -- judgement -----------------------------------------------------
    def finalize(self) -> Iterable[Finding]:
        if self._catalog_path is not None:
            yield from self._judge_metrics()
        if self._config_path is not None:
            yield from self._judge_knobs()

    def _judge_metrics(self) -> Iterable[Finding]:
        known = set(self._catalog)
        for path, line, col, name in self._uses:
            if name not in known:
                yield Finding(
                    self.rule, path, line, col,
                    f"metric name {name!r} is not in "
                    "metric_defs.CATALOG — the whole point is that "
                    "core metric names exist in one table; add the "
                    "row or fix the name",
                )
        local = known | self._grafana_local
        for path, line, col, tok in self._grafana:
            base = tok
            for suf in self._SERIES_SUFFIXES:
                if base.endswith(suf) and base.removesuffix(suf) in local:
                    base = base.removesuffix(suf)
                    break
            if base not in local:
                yield Finding(
                    self.rule, path, line, col,
                    f"grafana panel references {tok!r} which matches "
                    "no metric_defs.CATALOG entry nor a dashboard-"
                    "local gauge — the panel would render empty "
                    "forever",
                )
        # reverse direction: a catalog row nothing references is dead
        # weight (usually the leftover of a rename).  Only meaningful
        # when the run actually linted the runtime tree.
        if self._n_runtime_mods >= 1:
            referenced = self._all_literals | {
                t for _, _, _, t in self._grafana
            }
            for name, line in sorted(self._catalog.items()):
                if name not in referenced:
                    yield Finding(
                        self.rule, self._catalog_path, line, 0,
                        f"CATALOG entry {name!r} is referenced "
                        "nowhere in the linted tree — dead catalog "
                        "row (rename leftover?); drop it or wire the "
                        "instrumentation",
                    )

    def _judge_knobs(self) -> Iterable[Finding]:
        docs_dir = os.path.join(self.root, "docs")
        if not os.path.isdir(docs_dir):
            return
        corpus = []
        for p in sorted(glob.glob(os.path.join(docs_dir, "*.md"))):
            try:
                with open(p, "r", encoding="utf-8") as fh:
                    corpus.append(fh.read())
            except OSError:
                continue
        docs = "\n".join(corpus)
        for name, line, env in self._config_fields:
            if env not in docs:
                yield Finding(
                    self.rule, self._config_path, line, 0,
                    f"Config knob `{name}` ({env}) appears in no "
                    "docs/ knob table — every env-overridable tunable "
                    "must be documented (docs/configuration.md is the "
                    "full table)",
                )

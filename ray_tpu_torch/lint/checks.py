"""The rtlint rules (RT001–RT008): this repo's real invariants.

Each rule's *why* is documented in `docs/lint.md`; the short version
rides in each class docstring.  All name matching is import-gated
through `ModuleInfo.canonical` so a local variable named `time` cannot
trip a stdlib-name rule.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.lint.framework import (
    Check,
    Finding,
    ModuleInfo,
    register,
    shallow_walk,
)


def _last_segment(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_lockish(expr: ast.AST, mod: ModuleInfo) -> bool:
    """A `with` item that looks like a sync mutex: a threading lock
    constructed inline, or a name/attribute whose last segment contains
    'lock' or 'mutex' (the repo's naming convention: _lock, _spill_lock,
    _build_lock...)."""
    if isinstance(expr, ast.Call):
        return mod.canonical(expr.func) in {
            "threading.Lock",
            "threading.RLock",
            "threading.Semaphore",
            "threading.BoundedSemaphore",
            "threading.Condition",
        }
    last = _last_segment(expr).lower()
    return "lock" in last or "mutex" in last


def _numeric_constant(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    )


# ----------------------------------------------------------------------
_BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.getoutput",
    "os.system",
    "os.popen",
    "os.waitpid",
    "socket.create_connection",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.request",
}
# unambiguous blocking method names, matched without receiver type
_BLOCKING_METHODS = {"read_text", "write_text", "read_bytes", "write_bytes"}


def blocking_label(call: ast.Call, mod: ModuleInfo) -> Optional[str]:
    """Label of a known-blocking call, or None.  Shared by RT001
    (direct blocking in `async def`) and RT009 (blocking reachable
    from `async def` through the call graph)."""
    cn = mod.canonical(call.func)
    if cn in _BLOCKING_CALLS:
        return f"{cn}()"
    if cn == "open" and "open" not in mod.aliases:
        return "open()"
    if isinstance(call.func, ast.Attribute):
        if call.func.attr in _BLOCKING_METHODS:
            return f".{call.func.attr}()"
        # chained `...submit(...).result()` / run_coroutine_threadsafe
        if call.func.attr == "result" and isinstance(
            call.func.value, ast.Call
        ):
            inner = call.func.value.func
            if _last_segment(inner) in (
                "submit",
                "run_coroutine_threadsafe",
            ):
                return f"{_last_segment(inner)}(...).result()"
    return None


@register
class BlockingInAsync(Check):
    """RT001: a blocking call on an event-loop path stalls every task
    multiplexed on that loop — one daemon's `time.sleep(0.05)` freezes
    all of its RPC handling for 50ms."""

    rule = "RT001"
    name = "blocking-call-in-async"
    description = (
        "blocking call (time.sleep, subprocess.*, sync file/socket IO, "
        "Future.result) inside `async def` — use asyncio.sleep / "
        "run_in_executor"
    )

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for sub in shallow_walk(node.body):
                if not isinstance(sub, ast.Call):
                    continue
                label = blocking_label(sub, mod)
                if label:
                    yield Finding(
                        self.rule,
                        mod.path,
                        sub.lineno,
                        sub.col_offset,
                        f"blocking call {label} inside `async def "
                        f"{node.name}` stalls the event loop — await "
                        f"the async equivalent or run_in_executor",
                    )


# ----------------------------------------------------------------------
@register
class LockAcrossAwait(Check):
    """RT002: a threading lock held across an `await` parks the lock
    for the whole suspension — any OTHER coroutine or pool thread
    touching it deadlocks the loop (the classic asyncio/threading
    hybrid hang; asyncio.Lock + `async with` is the loop-safe shape)."""

    rule = "RT002"
    name = "lock-held-across-await"
    description = (
        "sync `with <lock>:` body contains `await` — the lock is held "
        "across suspension; use asyncio.Lock or restructure"
    )

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(
                _is_lockish(i.context_expr, mod) for i in node.items
            ):
                continue
            for sub in shallow_walk(node.body):
                if isinstance(sub, ast.Await):
                    yield Finding(
                        self.rule,
                        mod.path,
                        node.lineno,
                        node.col_offset,
                        "threading lock held across `await` (line "
                        f"{sub.lineno}) — suspension parks the lock; "
                        "use asyncio.Lock or drop it before awaiting",
                    )
                    break


# ----------------------------------------------------------------------
@register
class LockOrderCycle(Check):
    """RT003: the static race detector.  Collects every syntactic
    nested acquisition `with A: ... with B:` into a cross-module lock
    graph; a cycle in that graph is a latent ABBA deadlock, and a
    self-edge is a non-reentrant re-acquisition."""

    rule = "RT003"
    name = "lock-order-cycle"
    description = (
        "inconsistent lock-acquisition order across the codebase "
        "(cycle in the cross-module lock graph) — latent ABBA deadlock"
    )

    def __init__(self) -> None:
        # (outer_id, inner_id) -> every acquisition site; one finding
        # per site, so an inline suppression at one site cannot hide
        # the same cycle elsewhere
        self._edges: Dict[
            Tuple[str, str], List[Tuple[str, int, int]]
        ] = {}

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        stem = mod.path.rsplit("/", 1)[-1].removesuffix(".py")
        module_names = {
            t.id
            for n in mod.tree.body
            if isinstance(n, ast.Assign)
            for t in n.targets
            if isinstance(t, ast.Name)
        }

        def lock_id(expr: ast.AST, cls: str, fn: str) -> Optional[str]:
            if isinstance(expr, ast.Call):
                return None  # inline construction: no shared identity
            if isinstance(expr, ast.Attribute):
                base = expr.value
                if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                    return f"{stem}.{cls or fn}.{expr.attr}"
                # `locks.a_lock` resolves through the import alias map
                # so every importer agrees on one global identity
                if isinstance(base, ast.Name) and base.id in mod.aliases:
                    return mod.canonical(expr)
                head = _last_segment(base)
                return f"{stem}.{head}.{expr.attr}" if head else None
            if isinstance(expr, ast.Name):
                if expr.id in mod.aliases:  # from x import a_lock
                    return mod.aliases[expr.id]
                if expr.id in module_names:
                    return f"{stem}.{expr.id}"
                return f"{stem}.{fn}.{expr.id}"
            return None

        def walk(node: ast.AST, held: List[str], cls: str, fn: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, [], child.name, fn)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    # fresh call context: held locks don't flow into a
                    # nested def (it runs later, possibly elsewhere)
                    walk(child, [], cls, child.name)
                elif isinstance(child, ast.With):
                    acquired = []
                    for item in child.items:
                        if _is_lockish(item.context_expr, mod):
                            lid = lock_id(item.context_expr, cls, fn)
                            if lid:
                                if held or acquired:
                                    outer = (held + acquired)[-1]
                                    self._edges.setdefault(
                                        (outer, lid), []
                                    ).append((
                                        mod.path,
                                        item.context_expr.lineno,
                                        item.context_expr.col_offset,
                                    ))
                                acquired.append(lid)
                    walk(child, held + acquired, cls, fn)
                else:
                    walk(child, held, cls, fn)

        walk(mod.tree, [], "", "<module>")
        return ()

    def finalize(self) -> Iterable[Finding]:
        graph: Dict[str, Set[str]] = {}
        for a, b in self._edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        scc_of = _tarjan(graph)
        sizes: Dict[int, int] = {}
        for comp in scc_of.values():
            sizes[comp] = sizes.get(comp, 0) + 1
        for (a, b), sites in sorted(self._edges.items()):
            cyclic = a == b or (
                scc_of[a] == scc_of[b] and sizes[scc_of[a]] > 1
            )
            if not cyclic:
                continue
            why = (
                f"`{a}` re-acquired while already held"
                if a == b
                else f"`{a}` -> `{b}` is also acquired in the "
                f"reverse order elsewhere"
            )
            for path, line, col in sorted(set(sites)):
                yield Finding(
                    self.rule,
                    path,
                    line,
                    col,
                    f"lock-order cycle: {why} — pick one global order "
                    "or merge the locks",
                )


def _tarjan(graph: Dict[str, Set[str]]) -> Dict[str, int]:
    """Iterative Tarjan SCC; -> node -> component id."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    comp: Dict[str, int] = {}
    counter = [0]
    ncomp = [0]

    for root in sorted(graph):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            succs = sorted(graph[node])
            for i in range(pi, len(succs)):
                s = succs[i]
                if s not in index:
                    work[-1] = (node, i + 1)
                    work.append((s, 0))
                    advanced = True
                    break
                if s in on_stack:
                    low[node] = min(low[node], index[s])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp[w] = ncomp[0]
                    if w == node:
                        break
                ncomp[0] += 1
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return comp


# ----------------------------------------------------------------------
@register
class PickleOutsideSerialization(Check):
    """RT004: the no-pickle wire invariant (`core/wire.py`): `decode`
    never unpickles, and the only module allowed to deserialize
    payload bytes is `core/serialization.py` — a `pickle.loads` in a
    daemon turns any wire peer into remote code execution."""

    rule = "RT004"
    name = "pickle-outside-serialization"
    description = (
        "pickle.load/loads/Unpickler outside core/serialization.py — "
        "route through ray_tpu_torch.core.serialization (no-pickle wire "
        "invariant)"
    )

    _BANNED = {"pickle.loads", "pickle.load", "pickle.Unpickler"}

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.path.endswith("ray_tpu_torch/core/serialization.py"):
            return
        # runtime code only: tests pickle on purpose, to *verify* the
        # invariant (test_wire's smuggled-frame probe)
        if "ray_tpu_torch/" not in f"/{mod.path}":
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                cn = mod.canonical(node)
                if cn in self._BANNED and not isinstance(
                    getattr(node, "ctx", None), (ast.Store, ast.Del)
                ):
                    yield Finding(
                        self.rule,
                        mod.path,
                        node.lineno,
                        node.col_offset,
                        f"{cn} outside core/serialization.py — use "
                        "ray_tpu_torch.core.serialization.loads (or a wire "
                        "schema) so unpickling stays at one audited "
                        "chokepoint",
                    )


# ----------------------------------------------------------------------
@register
class SwallowedException(Check):
    """RT005: `except: pass` and friends turned real faults into
    silence 213 times before this linter existed.  A broad handler
    must log (debug is enough — context for the next incident) or
    re-raise; narrowing the exception type is the other legal fix."""

    rule = "RT005"
    name = "swallowed-exception"
    description = (
        "broad `except`/`except Exception` whose body neither logs "
        "nor re-raises — narrow the type or log at debug with context"
    )

    _LOG_HEADS = {"logging", "warnings", "traceback"}

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._broad(node.type, mod):
                continue
            if self._handled(node.body, mod):
                continue
            caught = (
                "bare except"
                if node.type is None
                else f"except {_last_segment(node.type) or 'Exception'}"
            )
            yield Finding(
                self.rule,
                mod.path,
                node.lineno,
                node.col_offset,
                f"{caught} swallows the exception silently — log it "
                "(logger.debug with context) or narrow the type",
            )

    def _broad(self, t: Optional[ast.AST], mod: ModuleInfo) -> bool:
        if t is None:
            return True
        if isinstance(t, ast.Tuple):
            return any(self._broad(e, mod) for e in t.elts)
        return _last_segment(t) in ("Exception", "BaseException")

    def _handled(self, body: List[ast.stmt], mod: ModuleInfo) -> bool:
        for sub in shallow_walk(body):
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Call):
                fn = sub.func
                cn = mod.canonical(fn)
                if cn.partition(".")[0] in self._LOG_HEADS:
                    return True
                if cn == "print":
                    return True
                if isinstance(fn, ast.Attribute):
                    recv = _last_segment(fn.value).lower()
                    if "log" in recv:  # logger.debug, self._logger.x
                        return True
                    if fn.attr in ("print_exc", "print_stack", "exception"):
                        return True
        return False


# ----------------------------------------------------------------------
@register
class RawRetryLoop(Check):
    """RT006: PR-3's fault-tolerance contracts.  (a) A retry loop that
    sleeps a constant re-synchronizes retry storms — pacing must come
    from core/retry.backoff_delay_s (+ RetryBudget).  (b) A ContextVar
    `.set()` whose token is discarded can never `reset()`: on a shared
    event loop the ambient deadline leaks into the next task."""

    rule = "RT006"
    name = "raw-retry-or-deadline-drop"
    description = (
        "retry loop pacing with a constant sleep instead of "
        "core/retry.py backoff/budget, or ContextVar.set() dropping "
        "the reset token (ambient-deadline leak)"
    )

    _SLEEPS = {"time.sleep", "asyncio.sleep"}

    def __init__(self) -> None:
        # two-phase cross-module state: ContextVars DEFINED anywhere,
        # by canonical dotted name, and `.set()`-token-drop sites on
        # IMPORTED names, resolved against that registry in finalize()
        # (catches `from core.runtime import _ambient_deadline;
        # _ambient_deadline.set(...)` in an rpc helper)
        self._defined: Set[str] = set()
        self._import_drops: List[Tuple[str, str, int, int, str]] = []

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.path.endswith("ray_tpu_torch/core/retry.py"):
            return
        yield from self._retry_loops(mod)
        yield from self._token_drops(mod)

    def finalize(self) -> Iterable[Finding]:
        for canonical, path, line, col, var in self._import_drops:
            if canonical in self._defined:
                yield Finding(
                    self.rule, path, line, col,
                    self._drop_message(var),
                )

    @staticmethod
    def _drop_message(var: str) -> str:
        return (
            f"{var}.set(...) discards the reset token — the ambient "
            "value leaks across tasks sharing this context; keep the "
            "token and reset() in a finally (suppress inline only if "
            "overwrite-by-design)"
        )

    def _retry_loops(self, mod: ModuleInfo) -> Iterable[Finding]:
        seen: Set[int] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.While, ast.For)):
                continue
            body = list(shallow_walk(node.body))
            if not any(isinstance(s, ast.ExceptHandler) for s in body):
                continue
            for sub in body:
                if (
                    isinstance(sub, ast.Call)
                    and mod.canonical(sub.func) in self._SLEEPS
                    and sub.args
                    and _numeric_constant(sub.args[0])
                    and sub.lineno not in seen
                ):
                    seen.add(sub.lineno)
                    yield Finding(
                        self.rule,
                        mod.path,
                        sub.lineno,
                        sub.col_offset,
                        "retry loop sleeps a constant "
                        f"({sub.args[0].value!r}) — constant pacing "
                        "synchronizes retry storms; use core/retry."
                        "backoff_delay_s and spend a RetryBudget token",
                    )

    def _token_drops(self, mod: ModuleInfo) -> Iterable[Finding]:
        ctxvars: Set[str] = set()
        for node in mod.tree.body:
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if (
                value is not None
                and isinstance(value, ast.Call)
                and mod.canonical(value.func)
                in ("contextvars.ContextVar", "ContextVar")
            ):
                ctxvars.update(
                    t.id for t in targets if isinstance(t, ast.Name)
                )
        modname = mod.path.removesuffix(".py").replace("/", ".")
        self._defined.update(f"{modname}.{n}" for n in ctxvars)
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "set"
                and isinstance(node.value.func.value, ast.Name)
            ):
                continue
            var = node.value.func.value.id
            if var in ctxvars:
                yield Finding(
                    self.rule,
                    mod.path,
                    node.lineno,
                    node.col_offset,
                    self._drop_message(var),
                )
            elif var in mod.aliases:
                # imported name: judged in finalize() once every
                # module's ContextVar definitions are known
                self._import_drops.append((
                    mod.aliases[var], mod.path,
                    node.lineno, node.col_offset, var,
                ))


# ----------------------------------------------------------------------
@register
class HostEffectInCapture(Check):
    """RT007: a CUDA graph capture walks the Python once and records
    only the kernels it launches; a replay reruns those kernels and no
    Python — a print/np.random/wall-clock call inside a capture region
    runs at capture time only (silently stale on every replay).

    This is the port's form of the JAX package's RT007 ("host effect in
    jit": `jax.jit`/`shard_map` trace Python once and replay XLA), which
    has no callee here.  The capture regions are the body of a
    `with torch.cuda.graph(...)` block and the function the engine's
    `EngineGraph(run, ...)` records (`serve/llm_engine.py`: its first
    argument, named directly or as a `self.` method).  The reference rule's second half, a donated buffer
    read after `jax.jit(..., donate_argnums=...)`, has no counterpart:
    eager PyTorch donates no buffers."""

    rule = "RT007"
    name = "host-effect-in-capture"
    description = (
        "host side effect (print, np.random, wall-clock) inside a CUDA "
        "graph capture region (a `torch.cuda.graph` block or the "
        "function an EngineGraph records)"
    )

    _HOST_CALLS = {
        "time.time",
        "time.perf_counter",
        "time.monotonic",
        "time.time_ns",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
        "os.urandom",
        "uuid.uuid4",
    }

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        by_name = {
            n.name: n
            for n in ast.walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        seen: Set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.With) and any(
                isinstance(i.context_expr, ast.Call)
                and mod.canonical(i.context_expr.func) == "torch.cuda.graph"
                for i in node.items
            ):
                yield from self._host_effects(
                    node.body, "a torch.cuda.graph block", mod, seen
                )
            elif (
                isinstance(node, ast.Call)
                and node.args
                and self._is_recorder(node.func, mod)
            ):
                target = by_name.get(self._callee_name(node.args[0]))
                if target is not None:
                    yield from self._host_effects(
                        target.body, f"recorded `{target.name}`", mod, seen
                    )

    @staticmethod
    def _is_recorder(func: ast.AST, mod: ModuleInfo) -> bool:
        cn = mod.canonical(func)
        return cn == "EngineGraph" or cn.endswith(".EngineGraph")

    @staticmethod
    def _callee_name(arg: ast.AST) -> str:
        if isinstance(arg, ast.Name):
            return arg.id
        if (
            isinstance(arg, ast.Attribute)
            and isinstance(arg.value, ast.Name)
            and arg.value.id == "self"
        ):
            return arg.attr
        return ""

    def _host_effects(
        self, body: List[ast.stmt], where: str, mod: ModuleInfo,
        seen: Set[int],
    ) -> Iterable[Finding]:
        for sub in shallow_walk(body):
            if not isinstance(sub, ast.Call) or id(sub) in seen:
                continue
            cn = mod.canonical(sub.func)
            label = None
            if cn in self._HOST_CALLS or cn == "print":
                label = cn
            elif cn.startswith("numpy.random.") or cn.startswith("random."):
                label = cn
            if label:
                seen.add(id(sub))
                yield Finding(
                    self.rule,
                    mod.path,
                    sub.lineno,
                    sub.col_offset,
                    f"host side effect {label}() inside {where} runs at "
                    "capture time only — a replay reruns the kernels, not "
                    "the Python; hoist it out of the capture",
                )


# ----------------------------------------------------------------------
@register
class UnseededRandomInTests(Check):
    """RT008: an unseeded RNG in a test is a flake generator — the
    chaos suites learned this in PR 3 (every RNG seeded for
    determinism); this pins it for all of tests/."""

    rule = "RT008"
    name = "unseeded-random-in-tests"
    description = (
        "module-level random/np.random use in tests/ without a seed "
        "anywhere in the file — seed it or use random.Random(seed)"
    )

    _RANDOM_FNS = {
        "random",
        "randint",
        "randrange",
        "choice",
        "choices",
        "shuffle",
        "sample",
        "uniform",
        "gauss",
        "random_sample",
        "rand",
        "randn",
        "permutation",
        "normal",
        "bytes",
    }

    def visit_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if "tests" not in mod.path.split("/"):
            return
        if self._file_seeds(mod):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cn = mod.canonical(node.func)
            head, _, fn = cn.rpartition(".")
            if head in ("random", "numpy.random") and fn in self._RANDOM_FNS:
                yield Finding(
                    self.rule,
                    mod.path,
                    node.lineno,
                    node.col_offset,
                    f"unseeded {cn}() in a test file — flake "
                    "generator; call random.seed / np.random.seed or "
                    "use an explicitly seeded Random/default_rng",
                )
            elif cn in ("numpy.random.default_rng", "random.Random") and (
                not node.args
                or (
                    isinstance(node.args[0], ast.Constant)
                    and node.args[0].value is None
                )
            ):
                yield Finding(
                    self.rule,
                    mod.path,
                    node.lineno,
                    node.col_offset,
                    f"{cn}() without a seed in a test file — pass an "
                    "explicit seed for determinism",
                )

    @staticmethod
    def _file_seeds(mod: ModuleInfo) -> bool:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cn = mod.canonical(node.func)
            if cn in ("random.seed", "numpy.random.seed"):
                return True
            if cn in ("numpy.random.default_rng", "random.Random"):
                if node.args and not (
                    isinstance(node.args[0], ast.Constant)
                    and node.args[0].value is None
                ):
                    return True
        return False

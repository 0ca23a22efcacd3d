"""The port's rtlint (`python -m ray_tpu_torch.lint`) on the CPU.

- Every per-rule fixture of the JAX package's `tests/test_lint.py`
  runs as written (its own assertions against the reference's linter),
  and the same tree, moved to `ray_tpu_torch/` paths and rewritten as a
  copy is (`test_torch_copies.rewrite`), gives the port's linter the
  same (rule, path, line) findings, RT007's aside.
- RT007 guards CUDA graph captures in the port (a `torch.cuda.graph`
  block, the function an `EngineGraph` records): capture fixtures of its
  own, and the reference's `jax.jit`
  fixtures draw no RT007 from it.
- The port's tree and tests are clean against the port's baseline, and
  that baseline grandfathers no (path, rule) count its original lacks.
"""

import functools
import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import test_lint as ref_tests
from ray_tpu.lint import lint_paths as ref_lint_paths
from ray_tpu.lint import load_baseline as ref_load_baseline
from ray_tpu.lint import rule_catalog as ref_rule_catalog
from ray_tpu_torch.lint import (
    compare_to_baseline,
    default_baseline_path,
    lint_paths,
    load_baseline,
    rule_catalog,
)
from test_torch_copies import rewrite

REPO = Path(__file__).resolve().parents[1]

# the reference's fixture cases: each takes a scratch `tmp_path` only
FIXTURE_CASES = sorted(
    name for name, fn in vars(ref_tests).items()
    if name.startswith("test_") and callable(fn)
    and list(inspect.signature(fn).parameters) == ["tmp_path"]
)


def _port_rel(rel: str) -> str:
    head, sep, rest = rel.partition("/")
    return f"ray_tpu_torch{sep}{rest}" if head == "ray_tpu" else rel


def _mirror(root: Path, dest: Path) -> None:
    """`root`'s tree at `dest`: `ray_tpu/` moved to `ray_tpu_torch/`,
    every file rewritten as a copy is."""
    for src in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = src.relative_to(root).as_posix()
        out = dest / _port_rel(rel)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(rewrite(src.read_text()))


def _key(f, port_path=False):
    return (f.rule, _port_rel(f.path) if port_path else f.path, f.line)


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_reference_fixture_gives_the_same_findings(case, tmp_path,
                                                   monkeypatch):
    compared = []

    def both(paths, *, select=None, root=None, stats=None):
        ref = ref_lint_paths(paths, select=select, root=root, stats=stats)
        dest = tmp_path / f"port{len(compared)}"
        _mirror(Path(root), dest)
        port = lint_paths(
            [str(dest / _port_rel(str(Path(p).relative_to(root))))
             for p in paths],
            select=select, root=str(dest))
        assert ({_key(f, True) for f in ref if f.rule != "RT007"}
                == {_key(f) for f in port if f.rule != "RT007"}), case
        # the reference's RT007 fixtures are `jax.jit` code: nothing a
        # CUDA graph captures
        assert not [f for f in port if f.rule == "RT007"], case
        compared.append(len(ref))
        return ref

    monkeypatch.setattr(ref_tests, "lint_paths", both)
    (tmp_path / "ref").mkdir()
    getattr(ref_tests, case)(tmp_path / "ref")
    assert compared, f"{case} linted nothing"


def test_fixture_cases_cover_every_rule():
    assert len(FIXTURE_CASES) >= 40
    for i in range(1, 14):
        assert any(c.startswith(f"test_rt{i:03d}_") for c in FIXTURE_CASES), i


# ----------------------------------------------------------------------
# RT007: host effects inside CUDA graph capture regions
# ----------------------------------------------------------------------
def _lint_snippet(tmp_path, code, rel="ray_tpu_torch/serve/mod.py"):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    return lint_paths([str(p)], root=str(tmp_path), select={"RT007"})


def test_rt007_capture_positive(tmp_path):
    out = _lint_snippet(
        tmp_path,
        """
        import time

        import numpy as np
        import torch

        def capture(run, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                t0 = time.perf_counter()
                y = run(x) * np.random.rand()
                print("captured", y)
            return g, y, t0
        """,
    )
    assert [(f.rule, f.line) for f in out] == [
        ("RT007", 10), ("RT007", 11), ("RT007", 12)]
    assert "torch.cuda.graph block" in out[0].message


def test_rt007_recorded_function_positive(tmp_path):
    out = _lint_snippet(
        tmp_path,
        """
        import random
        import uuid

        from ray_tpu_torch.serve.llm_engine import EngineGraph

        class Engine:
            def stepper(self):
                return EngineGraph(self._run_chunk, None)

            def _run_chunk(self, tables):
                return tables + random.random()

        def step(x):
            tag = uuid.uuid4()
            return x * 2

        stepper = EngineGraph(step)
        """,
    )
    assert [(f.rule, f.line) for f in out] == [("RT007", 12), ("RT007", 15)]
    assert "recorded `_run_chunk`" in out[0].message
    assert "recorded `step`" in out[1].message


def test_rt007_capture_negative(tmp_path):
    out = _lint_snippet(
        tmp_path,
        """
        import time

        import jax
        import torch

        @jax.jit
        def traced(x):
            print("a jax trace is not a capture", x)
            return x

        def capture(run, x, pool):
            t0 = time.perf_counter()  # before the capture
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                y = run(x)

                def later():
                    print("runs when called, not captured")
                out = later
            print("after", time.perf_counter() - t0)
            return g, y, out

        def eager(x):
            print("never captured")
            return x
        """,
    )
    assert out == []


def test_rt007_inline_suppression(tmp_path):
    out = _lint_snippet(
        tmp_path,
        """
        import time

        import torch

        def capture(run, g):
            with torch.cuda.graph(g):
                t1 = time.perf_counter()  # rtlint: disable=RT007
                run()
                t2 = time.perf_counter()
            return t2 - t1
        """,
    )
    assert [f.line for f in out] == [10]


def test_rt007_guards_the_engines_chunk_capture():
    """The engine's capture block times its record phase on purpose:
    both clock reads carry a suppression, and without them RT007 finds
    exactly those two."""
    src = (REPO / "ray_tpu_torch" / "serve" / "llm_engine.py").read_text()
    assert src.count("# rtlint: disable=RT007") == 2
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "ray_tpu_torch" / "serve" / "llm_engine.py"
        p.parent.mkdir(parents=True)
        p.write_text(src.replace("  # rtlint: disable=RT007", ""))
        out = lint_paths([str(p)], root=d, select={"RT007"})
    assert len(out) == 2
    assert all("time.perf_counter" in f.message for f in out)


# ----------------------------------------------------------------------
# the port's gate and its baseline
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _gate():
    """One run of `python -m ray_tpu_torch.lint --stats` as an operator
    runs it: its default paths (the port's tree and
    `tests/test_torch_*.py`) against its default baseline."""
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.lint", "--stats"],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
    )


def test_port_tree_is_clean_against_its_baseline():
    """The gate: a finding in the port's tree or tests that its baseline
    does not grandfather fails."""
    assert default_baseline_path() == str(
        REPO / "ray_tpu_torch" / "lint" / "lint_baseline.json")
    proc = _gate()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "rtlint: clean (" in proc.stdout
    # the run saw every grandfathered finding: the defaults reach the
    # whole tree the baseline was written from
    total = int(proc.stdout.split("\ntotal")[1].split()[0])
    assert total == sum(load_baseline(default_baseline_path()).values())


def test_baseline_grandfathers_nothing_the_original_lacks():
    """Each (path, rule) count of the port's baseline is at most the
    reference baseline's for the original path: a copy carries no
    finding its original lacks, and a module of the port's own (or a
    port test) none at all."""
    port = load_baseline(default_baseline_path())
    ref = ref_load_baseline(str(REPO / "lint_baseline.json"))
    assert port
    over = {}
    for key, n in port.items():
        path, rule = key.split("::")
        assert path.startswith("ray_tpu_torch/"), key
        orig = "ray_tpu/" + path.removeprefix("ray_tpu_torch/")
        if n > ref.get(f"{orig}::{rule}", 0):
            over[key] = (n, ref.get(f"{orig}::{rule}", 0))
    assert not over, over


def test_baseline_has_no_core_or_serve_debt():
    """The reference's burned-down invariants hold in the port's
    baseline too: no RT001 / RT002 / RT005 in core/ or serve/, no RT005
    in data/ or rllib/, nothing in dag/, no RT009-RT013 in core/ or
    serve/, and no parse error."""
    baseline = load_baseline(default_baseline_path())
    bad = [
        k for k in baseline
        if (k.split("::")[1] in ("RT001", "RT002", "RT005")
            and k.startswith(("ray_tpu_torch/core/", "ray_tpu_torch/serve/")))
        or (k.split("::")[1] == "RT005"
            and k.startswith(("ray_tpu_torch/data/", "ray_tpu_torch/rllib/")))
        or k.startswith("ray_tpu_torch/dag/")
        or (k.split("::")[1] in ("RT009", "RT010", "RT011", "RT012", "RT013")
            and k.startswith(("ray_tpu_torch/core/", "ray_tpu_torch/serve/")))
        or k.endswith("::RT000")
    ]
    assert not bad, bad


def test_seeded_violations_fail_the_ports_gate(tmp_path):
    """A deliberate violation of RT001 / RT002 / RT004 / RT005 / RT007,
    planted in a mirror of the port's tree, comes back NEW against the
    port's baseline."""
    plants = {
        "ray_tpu_torch/core/noded.py": """
            import pickle

            def handle(blob):
                return pickle.loads(blob)
            """,
        "ray_tpu_torch/serve/router.py": """
            import asyncio
            import threading

            lock = threading.Lock()

            async def route():
                with lock:
                    await asyncio.sleep(0.1)
            """,
        "ray_tpu_torch/core/runtime.py": """
            import time

            async def tick():
                time.sleep(1)

            def f():
                try:
                    risky()
                except Exception:
                    pass
            """,
        "ray_tpu_torch/serve/llm_engine.py": """
            import time

            import torch

            def capture(g, run):
                with torch.cuda.graph(g):
                    run(time.time())
            """,
    }
    for rel, code in plants.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
    findings = lint_paths([str(tmp_path / "ray_tpu_torch")],
                          root=str(tmp_path))
    want = {"RT001", "RT002", "RT004", "RT005", "RT007"}
    new, _ = compare_to_baseline(findings,
                                 load_baseline(default_baseline_path()))
    assert {f.rule for f in new} >= want


def test_interprocedural_pass_is_fast():
    """The gate's interprocedural rules (RT009-RT013, from `--stats`)
    stay under 30 s over the port's tree."""
    rows = {}
    for line in _gate().stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0].startswith("RT"):
            rows[parts[0]] = float(parts[2])
    inter = [r for r in rows if r >= "RT009"]
    assert inter == [f"RT{i:03d}" for i in range(9, 14)], rows
    spent = sum(rows[r] for r in inter)
    assert spent < 30.0, f"interprocedural pass took {spent:.1f}s: {rows}"


def test_rule_catalog_keeps_the_references_ids():
    port = rule_catalog()
    ref = ref_rule_catalog()
    assert [r for r, _n, _d in port] == [f"RT{i:03d}" for i in range(1, 14)]
    assert [r for r, _n, _d in port] == [r for r, _n, _d in ref]
    for (rule, name, _), (_, ref_name, _) in zip(port, ref):
        if rule != "RT007":
            assert name == ref_name, rule
    assert dict((r, n) for r, n, _ in port)["RT007"] == "host-effect-in-capture"


def test_cli_runs_clean(tmp_path):
    """The CLI's other exits: the gate's run is clean (0), the catalog
    lists from any directory (0), a missing path is a usage error
    (2)."""
    assert _gate().returncode == 0
    listed = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.lint", "--list-rules"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=60,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert listed.returncode == 0, listed.stderr
    assert "RT007  host-effect-in-capture" in listed.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.lint", "no/such/path"],
        capture_output=True, text=True, cwd=str(REPO), timeout=60,
    )
    assert bad.returncode == 2


def test_baseline_writer_round_trips(tmp_path):
    """`--write-baseline --baseline <path>` writes the current findings
    (here: one planted RT005) and a run against it is clean."""
    pkg = tmp_path / "ray_tpu_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(textwrap.dedent("""
        def f():
            try:
                risky()
            except Exception:
                pass
    """))
    base = tmp_path / "base.json"
    args = [sys.executable, "-m", "ray_tpu_torch.lint", str(pkg),
            "--baseline", str(base)]
    wrote = subprocess.run(args + ["--write-baseline"], capture_output=True,
                           text=True, cwd=str(REPO), timeout=60)
    assert wrote.returncode == 0, wrote.stderr
    [(key, n)] = load_baseline(str(base)).items()
    assert key.endswith("ray_tpu_torch/core/mod.py::RT005") and n == 1
    again = subprocess.run(args, capture_output=True, text=True,
                           cwd=str(REPO), timeout=60)
    assert again.returncode == 0 and "clean" in again.stdout

"""Nothing the benchmark runs imports JAX or the JAX package: an AST scan
of `port_bench/` by whole top-level module names (`ray_tpu_torch` is
the system under test; `ray_tpu` is refused), the references free of
the program too, and a tiny cell run in a process where importing
either name fails."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "ray_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    return [p for p in (PB / sub).rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    assert not set(imported_tops(path)) & BANNED


def test_references_import_nothing_of_the_program():
    for path in sources("reference"):
        assert not set(imported_tops(path)) & (BANNED | {"ray_tpu_torch"}), \
            path


def test_scan_compares_whole_names():
    assert "ray_tpu_torch".split(".")[0] not in BANNED
    assert "ray_tpu.core".split(".")[0] in BANNED


BLOCKED = textwrap.dedent("""
    import importlib.abc, sys, time
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {"jax", "jaxlib", "flax", "ray_tpu"}:
                raise ImportError(f"blocked: {name}")
            return None
    sys.meta_path.insert(0, Block())
    from pathlib import Path
    import torch
    from port_bench import run
    root = Path(run.ROOT) / "tests" / "tiny"
    bench = {"workloads": [{"name": "serve.tiny-llama",
                            "config": "tiny-llama", "traffic": "tiny_chat",
                            "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    cell = run.load_cell(bench, "serve.tiny-llama", root)
    cell.t_start = time.perf_counter()
    out = run.run_cell(bench, cell, 3, 0.5, False, torch.device("cpu"))
    assert out["correct"], out
    assert not run.banned_modules(), run.banned_modules()
    print("ran clean")
""")


def test_tiny_cell_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(PB.parent))
    res = subprocess.run([sys.executable, "-c", BLOCKED], cwd=PB.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ran clean" in res.stdout

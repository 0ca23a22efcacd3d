"""Each cell of BENCHMARK.json on the card: a short window through the
harness's own command, its result line read back.  Needs a CUDA card;
run there with

    python3 -m pytest port_bench/tests/test_pb_card.py -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_on_the_card(card, name, traced):
    res = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name,
         "--seed", "2147483999", "--seconds", "5", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["metrics"]
    assert list(out)[-1] == "checks"
    if traced:
        assert out["device"]["busy_s"] > 0
        for m in out["metrics"].values():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100

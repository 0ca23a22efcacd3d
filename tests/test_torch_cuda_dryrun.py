"""Card test of the multichip dry run (torch only: it runs where the card
is, without JAX).  Marked `cuda`; it skips here, where there is no card.

`python -m ray_tpu_torch.dryrun --ranks 4` spawns four gloo ranks that
share the card (their default device) and runs `dryrun_multichip(4)` in
each: GPT-2 over tp 2 x sp 2 with ring attention, the pp sub-mesh's
pipeline, Mixtral's step over ep 4 and the two-slice step, in the
reference's bf16.  Every rank prints its readings; each loss is finite
and the same on every rank.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.cuda
def test_dryrun_cli_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dry run's ranks run on it")
    run = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.dryrun", "--ranks", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=660)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    ranks = [json.loads(line) for line in run.stdout.splitlines()
             if line.startswith("{")]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3], run.stdout
    keys = ("gpt2_loss", "gpt2_grad_norm", "mixtral_loss",
            "multislice_loss", "pp_out_abs_sum")
    for r in ranks:
        assert r["mesh"] == {"dp": 1, "fsdp": 1, "tp": 2, "sp": 2}
        assert all(math.isfinite(r[k]) for k in keys), r
        assert {k: r[k] for k in keys} == {k: ranks[0][k] for k in keys}

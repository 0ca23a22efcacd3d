"""Readings that set the limits of a cell's comparison, on the card at
the cell's own size, several seeds in one process (the benchmark's own
runs do not run this):

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 \
        --seconds 15

Each seed runs the cell as the benchmark does (a short window) and
prints two lines:
- `program`: the run's result as `run.result` builds it, with the
  numbers its comparison reads.  Over a dozen seeds or more the
  largest is the lower reading.
- `control`: the same result with the comparison made against the
  control instead of the program: the reference, put in the program's
  place, computed one precision below the configuration's bf16 (every
  matrix product on float8 e4m3 operands, `reference/lowp.py`).  On
  each seed's own served requests it reads the gap of the token the
  control puts first at each position; through the harness's own
  comparison it has to come out `correct: false`.  The smallest over
  the seeds is the upper reading.

One JSON line each on standard output, then the card's power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import List, Optional

from port_bench import run as runmod


def _line(res: dict, **extra) -> dict:
    out = {k: c["value"] for k, c in res["checks"].items()}
    out.update(correct=res["correct"],
               metrics={k: m["value"] for k, m in res["metrics"].items()},
               info=res["info"], **extra)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    runmod.set_cache_env()
    import torch

    from port_bench.drivers import serve_closed_loop as sc
    from port_bench.reference.lowp import fp8_mm

    bench = runmod.load_bench()
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = runmod.load_cell(bench, args.workload)
        cell.t_start = t0 = time.perf_counter()
        obs = runmod.driver(cell.spec["driver"]).run(cell, seed, args.seconds,
                                                     False, device)
        tag = dict(seed=seed, workload=args.workload)
        print(json.dumps(_line(runmod.result(bench, cell, obs, False, device),
                               mode="program", **tag)), flush=True)
        checks, _ = sc.judge(cell, seed, obs.data["requests"], device,
                             mm=fp8_mm)
        obs.checks.update(checks)
        print(json.dumps(_line(runmod.result(bench, cell, obs, False, device),
                               mode="control", seconds=time.perf_counter() - t0,
                               **tag)), flush=True)
        del obs
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"power": runmod.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

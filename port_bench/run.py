"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m port_bench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout.  The cell is the entry of that name in
`BENCHMARK.json`'s `workloads`; everything else is found by name:
`port_bench/workloads/<cell>.json` (driver, engine or optimizer
settings, the comparison's limits), `port_bench/configs/<config>.json`
(the model as run), `port_bench/traffic/<traffic>.json` (the mix),
`port_bench/drivers/<driver>.py`, and one reader a per-layer metric in
`port_bench/metrics/<metric>.py`.

`--trace 0` prints the cell's end-to-end metrics; `--trace 1` traces a
few seconds of the window with `torch.profiler` and prints the cell's
per-layer metrics, `busy_s` / `window_s` and a `breakdown`.  Every run
checks what the timed path produced against the plain reference under
`port_bench/reference/` once the window has closed: the numbers
compared, each beside its limit, are the last lines on standard error
and the last key (`checks`) of the result line, the last line on
standard output.

Exits 2 without a result when no CUDA card (or fewer than the cell
asks for) is present, and 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "_cache"
# whole top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "ray_tpu")
# a run stuck this long prints every thread's stack and exits (1)
STUCK_S = 340


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc build is `ray_tpu_torch/ops/_build/`)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    spec: Dict      # workloads/<cell>.json
    config: Dict    # configs/<config>.json
    mix: Dict       # traffic/<traffic>.json
    t_start: float = T_START


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def load_bench(path: Path = Path("BENCHMARK.json")) -> Dict:
    return _json(path)


def load_cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    spec = _json(root / "workloads" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (entry["config"],
                                            entry["traffic"]):
        raise SystemExit(f"{name}: workloads/{name}.json names "
                         f"{spec['config']} / {spec['traffic']}, "
                         f"BENCHMARK.json {entry['config']} / "
                         f"{entry['traffic']}")
    return Cell(name, int(entry["chips"]), spec,
                _json(root / "configs" / f"{entry['config']}.json"),
                _json(root / "traffic" / f"{entry['traffic']}.json"))


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries that the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """The per-layer metric's reader module, `metrics/<name>.py`."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def device_info(device, chips: int) -> Dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(bench: Dict, cell: Cell, seed: int, seconds: float,
             trace: bool, device) -> Dict:
    """One run of `cell` on `device` (no look for a card: the tests
    drive a tiny cell on the CPU through here).  Returns the result
    line's object."""
    obs = driver(cell.spec["driver"]).run(cell, seed, seconds, trace,
                                          device)
    return result(bench, cell, obs, trace, device)


def result(bench: Dict, cell: Cell, obs, trace: bool, device) -> Dict:
    """The result line's object from a driver's `Observed`."""
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = int(obs.memory_peak_bytes)
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in cell_metrics(bench, cell.name, "end_to_end"):
            if m["name"] not in obs.e2e:
                raise RuntimeError(f"{cell.name}: the driver gave no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": obs.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell.name, "per_layer"):
            mod = reader(m["name"])
            for key in ("layer", "unit", "source", "moves"):
                if getattr(mod, key.upper()) != m[key]:
                    raise RuntimeError(f"metrics/{m['name']}.py says "
                                       f"{key} {getattr(mod, key.upper())!r}"
                                       f", BENCHMARK.json {m[key]!r}")
            value = mod.read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if obs.trace is not None:
            dev["busy_s"] = obs.trace.busy_s()
            dev["window_s"] = obs.trace.window_s
    checks = obs.checks
    correct = (bool(checks) and obs.attempted > 0 and obs.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": obs.attempted,
           "failed": obs.failed, "metrics": metrics, "device": dev}
    if trace and obs.trace is not None:
        out["breakdown"] = {"device_ops": obs.trace.top_ops(10),
                            "idle_gaps": obs.trace.idle_gaps(10)}
    out["info"] = obs.info
    out["checks"] = checks
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(STUCK_S, exit=True)
    set_cache_env()
    bench = load_bench()
    cell = load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   device)
    out["info"]["power"] = power_limit()
    gc.collect()
    found = banned_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

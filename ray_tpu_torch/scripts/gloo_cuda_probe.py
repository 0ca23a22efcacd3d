"""Which of DTensor's collectives this torch's gloo backend takes for CUDA
tensors.

    python -m ray_tpu_torch.scripts.gloo_cuda_probe [--timeout 90]

A DTensor redistribution issues functional collectives
(`all_gather_into_tensor`, `reduce_scatter_tensor`, `all_reduce`).  The
port's sharded step issues none of them: it stages every collective
through the host itself (`parallel.collectives`), because ranks sharing
one card talk over gloo (NCCL refuses two ranks on one GPU).  This reads
what such a group would meet: for each op, two ranks (this script,
`--rank`) share the card and run it once on CUDA tensors.  The reading
is "taken" (and whether the result is right), "refused" (the error),
"crashed" (the signal) or "hung" (past the timeout).  Prints one JSON
line: the card, torch and CUDA versions and each op's reading.  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")


def _rank(rank: int, port: str, op: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    group = dist.group.WORLD
    x = torch.arange(4, dtype=torch.float32, device=device) + 10 * rank
    calls = {
        "all_gather_into_tensor": lambda: funcol.all_gather_tensor(
            x, 0, group),
        "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(
            x, "sum", 0, group),
        "all_reduce": lambda: funcol.all_reduce(x, "sum", group)}
    want = {"all_gather_into_tensor": [0, 1, 2, 3, 10, 11, 12, 13],
            "reduce_scatter_tensor": [[10, 12], [14, 16]][rank],
            "all_reduce": [10, 12, 14, 16]}
    try:
        got = funcol.wait_tensor(calls[op]())
        torch.cuda.synchronize(device)
        reading = {"status": "taken", "device": str(got.device),
                   "right": got.cpu().tolist() == want[op]}
    except Exception as e:  # rtlint: disable=RT005 — the refusal is
        # the reading, written below
        reading = {"status": "refused", "error": (
            f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}")}
    with open(out, "w") as f:
        json.dump(reading, f)
    sys.stdout.flush()
    # gloo's threads torn down in the interpreter's exit can abort it
    os._exit(0)


def probe(op: str, timeout: float) -> dict:
    """Two ranks run `op` once; rank 0's reading, or how they ended."""
    work = tempfile.mkdtemp(prefix="rtt_gloo_probe_")
    try:
        return _probe(op, timeout, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _probe(op: str, timeout: float, work: str) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    outs = [os.path.join(work, f"r{r}.json") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.gloo_cuda_probe",
         "--rank", str(r), "--port", port, "--op", op, "--out", outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        for p in procs:
            p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"status": "hung", "timeout_s": timeout}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(c < 0 for c in codes):
        return {"status": "crashed", "signals": [-c for c in codes if c < 0]}
    readings = []
    for path in outs:
        if not os.path.exists(path):
            return {"status": "failed", "codes": codes}
        with open(path) as f:
            readings.append(json.load(f))
    return {**readings[0], "both_ranks": [r["status"] for r in readings]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=90.0)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port")
    ap.add_argument("--op", choices=OPS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, args.port, args.op, args.out)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "gloo_takes_cuda": {op: probe(op, args.timeout)
                                          for op in OPS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

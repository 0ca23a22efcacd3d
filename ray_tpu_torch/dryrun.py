"""The port's multichip dry run: the entry points of `__graft_entry__.py`
(beside the JAX package in this repository), on a process group.

entry()                -> (fn, example_args): GPT-2 124M's forward and
                          its example args, on the card unless `device`
                          says otherwise.
dryrun_multichip(n)    -> the full GPT-2 train step on `_factor_mesh(n)`
                          (every major axis when n allows, ring
                          attention over sp) with the parameters sharded
                          by the logical rules, then `pipeline_apply` on
                          a pp sub-mesh, one Mixtral train step over ep
                          and `dryrun_multislice(2, n // 2)`; tiny
                          shapes, one step each.
dryrun_multislice(s, d) -> one GPT-2 step on a hybrid `MeshSpec(slices=s)`
                          mesh of s x d ranks (dp across the slices,
                          fsdp / tp inside each).

Where the reference lays a mesh on `jax.devices()[:n]`, these lay it on
the ranks of an initialised `torch.distributed` world (ranks 0 .. n-1,
one rank a device): every rank of the world calls them, with the same
arguments.  The configs, shapes and optimizers are the reference's; the
weights and tokens are drawn from the same seeds with torch's
generators (`gpt2_inputs`, `pp_inputs`, `mixtral_inputs`), so they
differ from `jax.random`'s.  Each function returns its readings (the
reference prints or returns the loss) and raises on a non-finite one.

    python -m ray_tpu_torch.dryrun --ranks 4 [--device cpu]

spawns that many gloo ranks on this host, runs `dryrun_multichip` in
each (in the reference's bf16) and prints each rank's readings as one
JSON line; a rank that outlives `RANK_TIMEOUT_S` fails the run.  The ranks run
on the card (`cuda`, all of them on card `rank % count`) unless
`--device cpu` is given; every collective of a CUDA tensor over gloo
goes through the host (`parallel.collectives`).
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import socket
import subprocess
import sys
from typing import Dict, Optional

import torch

from ray_tpu_torch import resolve_device

RANK_TIMEOUT_S = 600.0


def entry(device=None):
    """(fwd, (params, tokens)): GPT-2 124M's forward over tokens [4, 512]
    of zeros, params from seed 0."""
    from ray_tpu_torch.models import gpt2

    device = resolve_device(device)
    cfg = gpt2.GPT2Config.gpt2_124m()
    params = gpt2.init_params(cfg, 0, device=device)
    tokens = torch.zeros((4, 512), dtype=torch.int32, device=device)

    def fwd(params, tokens):
        return gpt2.forward(cfg, params, tokens)

    return fwd, (params, tokens)


def _factor_mesh(n: int):
    """Split n devices over (dp, fsdp, tp, sp) — every major parallelism
    axis exercised when n allows."""
    axes = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    order = ["tp", "sp", "fsdp", "dp"]
    i = 0
    while n > 1:
        for ax in order[i % len(order) :] + order[: i % len(order)]:
            if n % 2 == 0 and (ax != "tp" or axes["tp"] < 4) and (
                ax != "sp" or axes["sp"] < 4
            ):
                axes[ax] *= 2
                n //= 2
                break
        else:
            axes["dp"] *= n
            n = 1
        i += 1
    return axes


# ----------------------------------------------------------------------
# the reference's tiny configs and their inputs
# ----------------------------------------------------------------------
def gpt2_config(axes: Dict[str, int], dtype=torch.bfloat16):
    """The multichip step's GPT-2: heads divisible by tp, ring attention
    when the mesh splits sp."""
    from ray_tpu_torch.models import gpt2

    return gpt2.GPT2Config(
        vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
        n_head=max(4, axes.get("tp", 1)),
        attention="ring" if axes.get("sp", 1) > 1 else "dense",
        remat=True, dtype=dtype)


def multislice_config(tp: int, dtype=torch.bfloat16):
    from ray_tpu_torch.models import gpt2

    return gpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=64,
                           n_layer=2, n_head=max(4, tp), dtype=dtype)


def _tokens(shape, vocab: int, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)


def gpt2_inputs(cfg, batch: int, seq: int, seed: int, device) -> tuple:
    """(params from seed 0, tokens [batch, seq + 1] from `seed`): the
    reference draws its params from key 0 and its tokens from key 1 (the
    multichip step) or 2 (the multi-slice step)."""
    from ray_tpu_torch.models import gpt2

    return (gpt2.init_params(cfg, 0, device=device),
            _tokens((batch, seq + 1), cfg.vocab_size, seed, device))


def pp_inputs(S: int, device) -> tuple:
    """({"w": [S, 16, 16] * 0.3} from seed 3, x [8, 16] from seed 4)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    w = torch.randn((S, 16, 16), generator=gen, device=device) * 0.3
    gen.manual_seed(4)
    x = torch.randn((8, 16), generator=gen, device=device)
    return {"w": w}, x


def pp_stage(p, xb):
    return torch.tanh(xb @ p["w"])


def mixtral_config(ep: int, dtype=torch.bfloat16):
    """The multichip step's Mixtral: one expert a rank of ep, top-1."""
    from ray_tpu_torch.models import mixtral

    return mixtral.MixtralConfig(
        vocab_size=128, max_seq_len=32, dim=32, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=48, num_experts=ep, top_k=1,
        dtype=dtype)


def mixtral_inputs(cfg, ep: int, device) -> tuple:
    """(params from seed 5, tokens [2 ep, 17] from seed 6)."""
    from ray_tpu_torch.models import mixtral

    return (mixtral.init_params(cfg, 5, device=device),
            _tokens((ep * 2, 17), 128, 6, device))


def mixtral_optimizer():
    """`optax.adamw(1e-3)`: no clip, its defaults."""
    from ray_tpu_torch.models import gpt2

    return gpt2.AdamW(lambda count: 1e-3, max_norm=float("inf"), b1=0.9,
                      b2=0.999, eps=1e-8, weight_decay=1e-4)


def _finite(what: str, x: float) -> float:
    if not math.isfinite(x):
        raise AssertionError(f"non-finite {what} {x}")
    return x


def _gpt2_step(cfg, spec, batch: int, seq: int, seed: int, device) -> dict:
    """One GPT-2 step with the params sharded by the logical rules over
    `spec`'s mesh and the batch split over its data axes."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import (optimizer_shardings, shard_params,
                                        tree_shardings)
    from ray_tpu_torch.parallel.sharding import distribute_tree
    from ray_tpu_torch.train.cuda_utils import prepare_batch

    mesh = spec.build(device_type=device.type)
    params, tokens = gpt2_inputs(cfg, batch, seq, seed, device)
    logical = gpt2.logical_axes(cfg)
    opt = gpt2.default_optimizer(total_steps=10)
    opt_state = distribute_tree(
        opt.init(params), mesh,
        optimizer_shardings(mesh, opt, params,
                            tree_shardings(mesh, logical)))
    params = shard_params(params, mesh, logical)
    step = gpt2.make_train_step(cfg, opt, mesh)
    _, _, metrics = step(params, opt_state, prepare_batch(tokens, mesh))
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"])}


def dryrun_multichip(n_devices: int, *, device=None,
                     dtype=torch.bfloat16) -> Dict:
    """The reference's multichip dry run over a world of `n_devices`
    ranks (every rank calls it).  Returns {"mesh",
    "gpt2_loss", "gpt2_grad_norm", "pp_out" (the pipeline's output on
    the pp sub-mesh's ranks, else None), "mixtral_loss" (None off the ep
    sub-mesh), "multislice_loss" (None when n is odd or under 4)}."""
    import torch.distributed as dist

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    device = resolve_device(device)
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"the dry run over {n_devices} devices takes a "
                         f"world of {n_devices} ranks, have {world}")
    rank = dist.get_rank()
    axes = _factor_mesh(n_devices)
    spec = MeshSpec(**axes)
    if rank == 0:
        print(f"dryrun mesh: {axes}", flush=True)
    cfg = gpt2_config(axes, dtype)
    gpt2_m = _gpt2_step(cfg, spec, axes["dp"] * axes["fsdp"] * 2,
                        32 * axes["sp"], 1, device)
    out = {"mesh": axes,
           "gpt2_loss": _finite("loss", gpt2_m["loss"]),
           "gpt2_grad_norm": gpt2_m["grad_norm"],
           "pp_out": None, "mixtral_loss": None, "multislice_loss": None}

    # pp / ep axes: the GPT-2 step shards dp / fsdp / tp / sp; pipeline
    # and expert parallelism run on their own sub-meshes
    if n_devices >= 2:
        S = 2 if n_devices < 4 else 4
        pp_mesh = MeshSpec(pp=S).build(range(S), device_type=device.type)
        if rank < S:
            sp_params, x = pp_inputs(S, device)
            pp_out = pipeline_apply(pp_stage, sp_params, x, pp_mesh, 4)
            if not bool(torch.isfinite(pp_out).all()):
                raise AssertionError("non-finite pipeline output")
            out["pp_out"] = pp_out.detach().cpu()

        # expert parallelism at the model level: one Mixtral train step
        # (routing, all_to_all dispatch, load-balance aux, backward)
        ep = min(4, n_devices)
        ep_mesh = MeshSpec(ep=ep).build(range(ep), device_type=device.type)
        if rank < ep:
            mx_cfg = mixtral_config(ep, dtype)
            mx_params, mx_tokens = mixtral_inputs(mx_cfg, ep, device)
            mx_opt = mixtral_optimizer()
            step = mixtral.make_train_step(mx_cfg, mx_opt, ep_mesh)
            _, _, mx_m = step(mx_params, mx_opt.init(mx_params), mx_tokens)
            out["mixtral_loss"] = _finite("Mixtral loss",
                                          float(mx_m["loss"]))

    # the multi-slice hybrid mesh: 2 slices x n / 2 ranks, dp split
    # slice-major, so the gradient sum over dp is the only cross-slice
    # collective
    if n_devices >= 4 and n_devices % 2 == 0:
        out["multislice_loss"] = dryrun_multislice(
            2, n_devices // 2, device=device, dtype=dtype)
    if rank == 0:
        extra = ("" if out["multislice_loss"] is None
                 else f", 2-slice loss={out['multislice_loss']:.4f}")
        print(f"dryrun_multichip({n_devices}) OK: "
              f"loss={out['gpt2_loss']:.4f} (+ pp/ep sub-mesh checks"
              f"{extra})", flush=True)
    return out


def dryrun_multislice(n_slices: int, devices_per_slice: int, *,
                      device=None, dtype=torch.bfloat16) -> float:
    """Hybrid-mesh train step: dp spans the slices, fsdp / tp stay inside
    each; one GPT-2 step over ranks 0 .. n_slices x devices_per_slice -
    1, its loss returned (finite, or it raises)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec

    device = resolve_device(device)
    n = n_slices * devices_per_slice
    if dist.get_world_size() != n:
        raise ValueError(f"a {n_slices} x {devices_per_slice} mesh takes a "
                         f"world of {n} ranks, have "
                         f"{dist.get_world_size()}")
    fsdp = max(1, devices_per_slice // 2)
    tp = devices_per_slice // fsdp
    spec = MeshSpec(dp=n_slices, fsdp=fsdp, tp=tp, slices=n_slices)
    if dist.get_rank() == 0:
        print(f"multislice mesh: {spec.sizes()} over {n_slices} slices",
              flush=True)
    m = _gpt2_step(multislice_config(tp, dtype), spec, 2 * n_slices * fsdp,
                   32, 2, device)
    return _finite("multislice loss", m["loss"])


# ----------------------------------------------------------------------
# the command line: gloo ranks on this host
# ----------------------------------------------------------------------
def _rank_main(rank: int, world: int, port: str, device: str) -> int:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        if device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.cuda.set_device(rank % torch.cuda.device_count())
        out = dryrun_multichip(world, device=device)
        pp = out.pop("pp_out")
        out["pp_out_abs_sum"] = None if pp is None else float(
            pp.abs().sum())
        print("DRYRUN " + json.dumps({"rank": rank, **out}), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without a "
                         "card)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device).type)
    if args.rank is not None:
        return _rank_main(args.rank, args.ranks, args.port, device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "1"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.dryrun", "--ranks",
         str(args.ranks), "--device", device, "--rank", str(r),
         "--port", port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(args.ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        print(f"a rank outlived {RANK_TIMEOUT_S} s", flush=True)
        return 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r, log in enumerate(logs):
        lines = log.splitlines()
        if r in failed:
            print(f"rank {r} failed ({procs[r].returncode}):\n"
                  + "\n".join(lines[-40:]), flush=True)
            continue
        for line in lines:
            if r == 0 and not line.startswith("DRYRUN "):
                print(line)
        print(next(line[len("DRYRUN "):] for line in lines
                   if line.startswith("DRYRUN ")), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Card test of the CLI plane's GPU pool (torch only: it runs where the
card is, without JAX).  Marked `cuda`; it skips here, where there is no
card.  Run from the repo root: it imports `chip_smoke`.

`util.multiprocessing.Pool(processes=2, ray_remote_args={"num_gpus":
0.5})` over four seeded `chip_smoke.pool_flash_item`s at a cut shape
(B 2, H 4, T 256, D 64, bf16, causal): each item runs `flash_attention`
forward and backward in a pool worker (one K1 and one K2, no plain
dispatch), within `FLASH_TOL["bf16"]` of the plain versions; two worker
processes, each pinned to the one card and seeing one device; `imap_unordered` gives `map`'s
digests, and item 0 recomputed in this process gives the worker's O.
Then `status` through the CLI reads the head's `GPU` 1.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_waits import within

SHAPE, ITEMS = (2, 4, 256, 64), 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pool's items launch the flash "
                    "kernels")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gpu_pool_runs_flash_attention_in_its_workers(card):
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch.api import _session
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util.multiprocessing import Pool

    _build.build_all()
    tol = chip_smoke.FLASH_TOL["bf16"]
    item = chip_smoke.pool_flash_item("cuda", tol)
    args = [(i, SHAPE) for i in range(ITEMS)]
    rt.init(num_workers=2, num_cpus=4)
    try:
        with Pool(processes=2, ray_remote_args={"num_gpus": 0.5}) as pool:
            mapped = within(300.0, lambda: pool.map(item, args, chunksize=2))
            unordered = within(120.0, lambda: list(
                pool.imap_unordered(item, args)))
        assert len({r["pid"] for r in mapped + unordered}) == 2
        for r in mapped + unordered:
            # half a card pins that card: one device, named in the
            # worker's environment and read back by util.accelerators
            assert r["device_count"] == 1, r
            env = r["cuda_visible_devices"]
            assert env is not None and "," not in env, r
            assert r["visible_chip_ids"] == [env], r
            assert r["launches"] == {"flash_fwd": 1, "flash_bwd_fused": 1,
                                     "flash_bwd_dq": 0,
                                     "flash_bwd_dkv": 0}, r
            assert r["plain_dispatches"] == 0
            for name, e in r["errs"].items():
                assert e[1] <= 1.0 and e[2] <= tol["rel"], (name, e)
        assert {r["digest"] for r in unordered} == {
            r["digest"] for r in mapped}
        assert item(args[0])["digest"] == mapped[0]["digest"]
        ready = os.path.join(_session["session_dir"], "ready.json")
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address",
             ready, "status"], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout)["total_resources"]["GPU"] == 1.0
    finally:
        rt.shutdown()

"""The port's perf harness (`ray_tpu_torch.scripts.perf`) on the CPU: the
counterparts of `tests/test_perf_harness.py`'s cases for the runtime
matrix, the core split, core pinning and the engine rows, each through
the port's `main` with the reference test's argv and gates and
`--device cpu` (on the CPU the decode rows' kernel route dispatches the
kernels' plain versions).  Without `--device` the engine rows run on the
card, and raise where there is none.

Then the port against the JAX package's harness: on the same argv and
seed, the same rows (the decode route `pallas` is the port engine's
`kernel`) with the same keys, and equal values where no clock moves;
equal rows from the helpers (`owner_shard_report`, `_engine_run`) on
equal inputs; the same command-line options, the port's `--device`
apart."""

import concurrent.futures
import json
import os
import re

import numpy as np
import pytest
import torch

from test_torch_waits import within


def _main(argv, seconds=120.0):
    from ray_tpu_torch.scripts.perf import main

    return within(seconds, lambda: main([*argv, "--device", "cpu"]))


def test_perf_harness_subset(tmp_path):
    out = tmp_path / "perf.json"
    results = _main([
        "--filter", "client tasks sync",
        "--rounds", "1",
        "--round-sec", "0.2",
        "--num-workers", "2",
        "--json", str(out),
    ])
    assert "single client tasks sync" in results
    assert results["single client tasks sync"]["ops_per_s"] > 0
    saved = json.loads(out.read_text())
    assert saved == results


def test_perf_harness_actor_row():
    results = _main([
        "--filter", "1:1 actor calls sync",
        "--rounds", "1",
        "--round-sec", "0.2",
        "--num-workers", "2",
    ])
    assert results["1:1 actor calls sync"]["ops_per_s"] > 0


def test_core_split_accounting():
    """--core-split: per-plane CPU accounting is internally consistent
    (the port's daemon and workers are named by their command lines)."""
    results = _main([
        "--filter", "ZZZNONE",  # skip the matrix; core-split only
        "--core-split",
        "--storm-n", "300",
        "--num-workers", "2",
    ])
    split = results["core_split"]
    assert split["measured_tasks_per_s"] > 0
    assert split["projected_pipelined_tasks_per_s"] > 0
    assert split["driver_us_per_task"] > 0
    assert split["worker_us_per_task"] > 0
    assert split["num_workers"] >= 1.0
    assert split["bottleneck"] in ("driver", "noded", "worker_pool")


def test_pin_cores_rejects_oversubscription():
    from ray_tpu_torch.scripts.perf import apply_core_pinning

    have = len(os.sched_getaffinity(0))
    with pytest.raises(RuntimeError, match="needs"):
        apply_core_pinning(have + 1)


def test_engine_trace_smoke_rows():
    """`--engine-trace`: budget invariance (equal gather widths on the
    sized and the over-provisioned pool) and radix reuse (prefix_on
    prefills fewer tokens than prefix_off)."""
    results = _main(["--engine-trace", "--engine-requests", "12"])
    smoke = results["serve_llm_cb_smoke"]
    assert smoke["tokens_per_sec"] > 0
    assert smoke["ticks"] > 0
    assert results["sized"]["gather_blocks"] == \
        results["overprovisioned"]["gather_blocks"] > 0
    assert results["overprovisioned"]["kv_budget_tokens"] > \
        5 * results["sized"]["kv_budget_tokens"]
    assert results["prefix_on"]["prefix_hit_tokens"] > 0
    assert results["prefix_on"]["prefill_tokens"] < \
        results["prefix_off"]["prefill_tokens"]
    assert results["prefix_off"]["prefix_hit_tokens"] == 0


def test_decode_kernel_rows():
    """`--config decode_kernel`: the kernel rows dispatched the kernel
    route only and the gather rows the gather route only, at equal
    ticks; the int8 pool sits at half the bf16 payload, its scale
    sidecar priced apart."""
    results = _main(["--config", "decode_kernel", "--decode-batches", "4"])
    ker, gat = results["decode_b4_kernel"], results["decode_b4_gather"]
    assert ker["decode_kernel"] == "kernel"
    assert ker["kernel_ticks"] > 0 and ker["fallback_ticks"] == 0
    assert gat["decode_kernel"] == "gather"
    assert gat["kernel_ticks"] == 0 and gat["fallback_ticks"] > 0
    assert ker["tokens_per_sec"] > 0 and gat["tokens_per_sec"] > 0
    assert ker["ticks"] == gat["ticks"] > 0
    occ = results["kv_pool_occupancy"]
    assert occ["int8_payload_ratio"] == 0.5
    assert occ["kv_scale_bytes_int8"] > 0 == occ["kv_scale_bytes_fp"]


def test_overload_row():
    """`--overload`: exact admission accounting (both outcomes occur),
    sheds never reach prefill, the queue stays under its cap, the block
    pool comes back whole, TTFT percentiles well formed."""
    results = _main(["--overload"])
    storm = results["overload_storm"]
    assert storm["offered"] == (storm["admitted"] + storm["rejected"]
                                + storm["shed"])
    assert storm["rejected"] > 0 and storm["shed"] > 0
    assert storm["shed"] == storm["shed_expired"] + storm["shed_predicted"]
    assert storm["prefill_calls"] == storm["admitted"]
    assert storm["queue_peak"] <= storm["queue_cap"]
    assert storm["blocks_free_delta"] == 0
    assert storm["admitted_tok_s"] > 0
    ttft = results["overload_ttft"]
    assert 0 < ttft["ttft_p50_ms"] <= ttft["ttft_p99_ms"]
    assert ttft["concurrency"] == 2 * 4.0  # 2x the engine's slots


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="this machine has a CUDA card")
def test_engine_rows_need_the_card_unless_asked():
    """Without `--device` the engine rows and rllib_ppo's learner run on
    the card: with none they raise before any row, never carrying on on
    the CPU."""
    from ray_tpu_torch.scripts import perf

    for argv in (["--engine-trace", "--engine-requests", "1"],
                 ["--overload"],
                 ["--config", "decode_kernel", "--decode-batches", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            within(60.0, lambda: perf.main(argv))
    with pytest.raises(RuntimeError, match="CUDA"):
        perf.measure_serve_obs_overhead(requests=1, rounds=1)


def test_owner_shard_report_matches_jax():
    from ray_tpu.scripts import perf as jperf
    from ray_tpu_torch.scripts import perf as tperf

    rng = np.random.default_rng(0)
    before, after = [], []
    for shard in range(3):
        b = {"shard": shard, "submitted": int(rng.integers(0, 500)),
             "completed": int(rng.integers(0, 500)),
             "cpu_s": float(rng.random())}
        before.append(b)
        after.append({"shard": shard,
                      "submitted": b["submitted"] + int(rng.integers(0, 900)),
                      "completed": b["completed"] + int(rng.integers(0, 900))
                      * (shard != 1),  # one shard that completed nothing
                      "cpu_s": b["cpu_s"] + float(rng.random())})
    got = tperf.owner_shard_report(before, after)
    assert got == jperf.owner_shard_report(before, after)
    assert got[1]["us_per_task"] == 0.0 and got[0]["completed"] > 0


class _StubEngine:
    """`submit` resolves at once; `stats` returns seeded counters, the
    second call's grown from the first's."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        first = {k: int(rng.integers(0, 1000))
                 for k in ("prefix_hit_tokens", "prefill_tokens", "ticks",
                           "prefill_calls")}
        later = {k: v + int(rng.integers(1, 1000)) for k, v in first.items()}
        for s in (first, later):
            s.update(tick_ema_s=float(rng.random()),
                     ttft_ema_s=float(rng.random()),
                     gather_blocks=int(rng.integers(1, 64)))
        self._stats = [first, later]
        self._calls = 0

    def stats(self):
        s = self._stats[min(self._calls, 1)]
        self._calls += 1
        return dict(s)

    def submit(self, prompt, n_new):
        fut = concurrent.futures.Future()
        fut.set_result([0] * n_new)
        return fut


def test_engine_run_matches_jax():
    """`_engine_run` over the same stub engine gives the same row in both
    packages, apart from the wall-clock fields."""
    from ray_tpu.scripts import perf as jperf
    from ray_tpu_torch.scripts import perf as tperf

    prompts = [[1, 2, 3]] * 4
    for seed in range(3):
        got = tperf._engine_run(_StubEngine(seed), prompts, 8)
        want = jperf._engine_run(_StubEngine(seed), prompts, 8)
        for row in (got, want):
            assert row.pop("wall_s") >= 0 and row.pop("tokens_per_sec") > 0
        assert got == want
        assert got["ticks"] > 0 and 0 < got["prefix_hit_rate"] < 1


def _options(main, capsys) -> set:
    with pytest.raises(SystemExit) as exit_:
        main(["--help"])
    assert exit_.value.code == 0
    return set(re.findall(r"^  (--?[\w-]+)", capsys.readouterr().out, re.M))


def test_help_options_match_jax(capsys):
    from ray_tpu.scripts import perf as jperf
    from ray_tpu_torch.scripts import perf as tperf

    port = _options(tperf.main, capsys)
    ref = _options(jperf.main, capsys)
    assert len(ref) > 40 and "--decode-batches" in ref
    assert port - {"--device"} == ref
    assert "--device" in port


# the values no clock moves: budgets, gather widths, the pools' bytes,
# and the prefilled tokens of a run with the prefix cache off
_TIMING_FREE = {
    "sized": ("kv_budget_tokens", "gather_blocks"),
    "overprovisioned": ("kv_budget_tokens", "gather_blocks"),
    "prefix_on": ("gather_blocks",),
    "prefix_off": ("gather_blocks", "prefill_tokens"),
    "serve_llm_cb_smoke": ("gather_blocks",),
    "decode_b4_pallas": ("gather_blocks",),
    "decode_b4_gather": ("gather_blocks",),
    "kv_pool_occupancy": ("kv_pool_bytes_fp", "kv_scale_bytes_fp",
                          "kv_pool_bytes_int8", "kv_scale_bytes_int8",
                          "int8_payload_ratio"),
}


@pytest.mark.parametrize("argv", [
    ["--engine-trace", "--engine-requests", "12"],
    ["--config", "decode_kernel", "--decode-batches", "4"],
], ids=["engine_trace", "decode_kernel"])
def test_engine_and_decode_rows_match_jax(argv):
    """Both harnesses on the same argv and seed (the JAX package's
    kernel in Pallas interpret mode, the port's kernel route on the
    plain versions): the same rows, `pallas` named `kernel`, each with
    the same keys; the timing-free values equal."""
    from ray_tpu.scripts import perf as jperf
    from ray_tpu_torch.scripts import perf as tperf

    want = within(180.0, lambda: jperf.main(argv))
    got = within(180.0, lambda: tperf.main([*argv, "--device", "cpu"]))
    assert sorted(got) == sorted(n.replace("pallas", "kernel") for n in want)
    for name, row in want.items():
        port_row = got[name.replace("pallas", "kernel")]
        assert sorted(port_row) == sorted(row), name
        for key in _TIMING_FREE[name]:
            assert port_row[key] == row[key], (name, key)
        if "decode_kernel" in row:
            assert port_row["decode_kernel"] == \
                row["decode_kernel"].replace("pallas", "kernel")

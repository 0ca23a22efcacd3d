"""The port's perf harness on the CPU: the counterparts of
`tests/test_perf_harness.py`'s cluster-owning rows (data_shuffle and its
integrity modes, storage_faults, obs_overhead, dag_calls, elastic
recovery, rllib_ppo), each through the port's `main` with the reference
test's argv and gates and `--device cpu`, and the scalability envelope
at small sizes.  Each row boots and shuts down a port cluster of its
own."""

import pytest

from test_torch_waits import within


def _main(argv, seconds=180.0):
    from ray_tpu_torch.scripts.perf import main

    return within(seconds, lambda: main([*argv, "--device", "cpu"]))


def test_data_shuffle_row():
    """The exchange of a dataset twice the store completes through the
    spilling plane (spilled files under the port's session), every row
    out exactly once, globally sorted."""
    results = _main([
        "--config", "data_shuffle",
        "--shuffle-rows", "3200000",
        "--shuffle-store-mb", "12",
    ])
    row = results["data_shuffle"]
    assert row["rows_per_s"] > 0
    assert row["store_ratio"] >= 2.0
    assert row["spill_bytes"] > 0
    assert row["rows_out"] == row["rows"]
    assert row["rows_exact"] == 1.0
    assert row["globally_sorted"] == 1.0


def test_data_shuffle_integrity_modes():
    """`--shuffle-integrity both`: both runs exact and spilling, the
    knob (`RTT_OBJECT_INTEGRITY`) recorded in each row."""
    results = _main([
        "--config", "data_shuffle",
        "--shuffle-rows", "800000",
        "--shuffle-store-mb", "4",
        "--shuffle-integrity", "both",
    ])
    on = results["data_shuffle"]
    off = results["data_shuffle_integrity_off"]
    assert on["rows_exact"] == 1.0 and off["rows_exact"] == 1.0
    assert on["spill_bytes"] > 0 and off["spill_bytes"] > 0
    assert on["integrity_on"] == 1.0 and off["integrity_on"] == 0.0
    assert "overhead_pct" in results["integrity_overhead"]


def test_storage_faults_row():
    """The seeded bit-flip + ENOSPC + EIO schedule (`RTT_DISK_CHAOS`)
    fired on the spill plane, and the epoch still came out exact."""
    results = _main([
        "--config", "storage_faults",
        "--storage-faults-rows", "800000",
        "--storage-faults-store-mb", "4",
        "--storage-faults-seed", "1313",
    ])
    row = results["storage_faults"]
    assert row["rows_exact"] == 1.0
    assert row["rows_per_s"] > 0
    assert row["store_ratio"] >= 1.5
    assert row["seed"] == 1313.0
    assert (row["integrity_errors"] + row["spill_io_errors"]
            + row["spill_disk_full"]) > 0, (
        "no faults fired — the chaos schedule never touched the run"
    )


def test_obs_overhead_row():
    """Both halves of the observability A/B proved their instrumented
    path ran, and neither costs a structural multiple of throughput."""
    results = _main([
        "--config", "obs_overhead",
        "--obs-storm-n", "300",
        "--obs-rounds", "2",
        "--obs-serve-requests", "8",
        "--num-workers", "2",
    ])
    row = results["obs_overhead"]
    off, on = results["metrics_off"], results["metrics_on"]
    readings = (f"overhead_pct={row['overhead_pct']}, tasks/s off "
                f"{off['tasks_per_s']} ({off['tasks_per_s_min']}-"
                f"{off['tasks_per_s_max']}), on {on['tasks_per_s']} "
                f"({on['tasks_per_s_min']}-{on['tasks_per_s_max']})")
    assert off["tasks_per_s"] > 0, readings
    assert on["tasks_per_s"] > 0, readings
    assert row["instrumented"] == 1.0, readings
    assert -50.0 < row["overhead_pct"] < 50.0, readings
    srow = results["serve_obs_overhead"]
    soff, son = results["serve_obs_off"], results["serve_obs_on"]
    readings = (f"overhead_pct={srow['overhead_pct']}, tokens/s off "
                f"{soff['tokens_per_sec']} ({soff['tokens_per_sec_min']}-"
                f"{soff['tokens_per_sec_max']}), on {son['tokens_per_sec']} "
                f"({son['tokens_per_sec_min']}-{son['tokens_per_sec_max']})")
    assert soff["tokens_per_sec"] > 0, readings
    assert son["tokens_per_sec"] > 0, readings
    assert srow["instrumented"] == 1.0, readings
    assert -50.0 < srow["overhead_pct"] < 50.0, readings


def test_dag_calls_row():
    """The compiled plane beats the 1:1 actor plane in one cluster; both
    tensor-channel paths measured."""
    results = _main([
        "--config", "dag_calls",
        "--dag-calls-n", "300",
        "--dag-tensor-mb", "1.0",
        "--num-workers", "2",
    ])
    row = results["dag_calls"]
    assert row["actor_us_per_call"] > 0
    assert row["dag_us_per_call"] > 0
    assert row["dag_us_per_call"] < row["actor_us_per_call"]
    assert row["speedup"] == pytest.approx(
        row["actor_us_per_call"] / row["dag_us_per_call"], rel=1e-6
    )
    assert row["tensor_inline_mb_s"] > 0
    assert row["tensor_spill_mb_s"] > 0


def test_elastic_recovery_row():
    """One SIGKILLed rank of a `CudaTrainer` group: detected through the
    health plane, one failover, resumed at or before the kill step from
    the latest checkpoint, every step delivered at full width."""
    results = _main(["--elastic-recovery", "--elastic-steps", "10"])
    row = results["elastic_recovery"]
    assert row["failovers"] == 1.0
    assert 0.0 < row["detect_s"] < row["mttr_s"]
    assert 0.0 < row["resume_step"] <= row["kill_step"]
    assert row["final_step"] == 9.0
    assert row["reform_width"] == 2.0


def test_rllib_ppo_row():
    """The fleet row at the reference test's small shape, the learner a
    gang of two shards (the CLI's default) on the CPU: both headline
    metrics, exactly-once accounting, the overlap ran."""
    results = _main([
        "--config", "rllib_ppo",
        "--rllib-runners", "2",
        "--rllib-envs-per-runner", "4",
        "--rllib-rollout-len", "16",
        "--rllib-iters", "2",
    ])
    row = results["rllib_ppo"]
    assert row["env_steps_per_s"] > 0
    assert row["updates_per_s"] > 0
    assert row["accounting_exact"] == 1.0
    assert row["env_steps"] == row["ledger_env_steps"] > 0
    assert row["overlap"] == 1.0
    assert 0.0 <= row["overlap_ratio"] <= 1.0
    assert row["gang_devices"] >= 2.0


def test_envelope_rows_at_small_sizes():
    """`--envelope` at small sizes: every single-node row comes back
    well formed and holds no `"error"` (the harness records a row's
    exception as the row)."""
    results = _main([
        "--envelope", "--envelope-rows", "args,returns,get,queue,large",
        "--envelope-args-n", "300", "--envelope-returns-n", "300",
        "--envelope-get-n", "300", "--envelope-queue-n", "300",
        "--envelope-large-gb", "0.01", "--num-workers", "2",
    ])
    assert sorted(results) == ["args", "get", "large", "queue", "returns"]
    for name, row in results.items():
        assert "error" not in row, (name, row)
    assert results["args"]["n"] == 300 and results["args"]["total_s"] >= 0
    assert results["returns"]["n"] == 300
    assert results["get"]["n"] == 300
    queue = results["queue"]
    assert queue["n"] == 300 and queue["tasks_per_s"] > 0
    assert queue["driver_rss_gb"] > 0
    large = results["large"]
    assert large["gib"] == 0.01
    assert large["put_s"] >= 0 and large["get_s"] >= 0

"""The port's rllib runner fleet (`ray_tpu_torch.rllib`) under real
SIGKILL storms, with the learner on the CPU: the JAX package's
`tests/test_chaos_rllib.py` cases on the port, which hold the fleet's
runner replacement (`EnvRunnerGroup._replace_runner` and
`_bootstrap_replacement`).  Runner pids come from the port's
`testing.list_workers`.

The contracts:
1. kill-storm on env runners mid-iteration -> the fleet restores to
   full width and training continues with EXACT env-step/sample
   accounting — no lost or double-counted batches (the ledger's
   (slot, incarnation, seq) exactly-once key);
2. with deterministic replacement (sync fleet), the kill-storm run's
   loss trajectory is BIT-IDENTICAL to an unkilled control run —
   replacements replay the dead incarnation's weights history, so the
   consumed batches are the same bytes.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.testing import list_workers
from test_torch_waits import within

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=8, num_cpus=32, ignore_reinit_error=True)
    yield
    rt.shutdown()


def _runner_pids(group):
    """pid of every live env-runner actor worker."""
    by_actor = {w["actor_id"]: w["pid"] for w in list_workers()
                if w["actor_id"]}
    pids = []
    for r in group._runners:
        pid = by_actor.get(r._actor_id.hex())
        if pid is not None:
            pids.append(pid)
    return pids


def _kill(pid) -> bool:
    try:
        os.kill(pid, signal.SIGKILL)
        return True
    except ProcessLookupError:
        return False


def test_async_fleet_survives_kill_storm_exact_accounting(cluster):
    """SIGKILL a rotating subset of env runners WHILE the async
    overlap pipeline trains.  The fleet must restore to full width,
    every iteration must keep producing learner updates, and the
    exactly-once ledger must balance: consumed env steps == ledger
    records, zero duplicates (duplicate consumption raises inside the
    ledger)."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=4, num_envs_per_env_runner=4,
                     rollout_fragment_length=16)
        .learners(device="cpu")
        .training(lr=3e-4, minibatch_size=128, num_epochs=2,
                  sample_train_overlap=True)
        .debugging(seed=0)
        .build()
    )
    killed = []
    stop = threading.Event()

    def killer():
        rng = np.random.default_rng(7)
        while not stop.is_set():
            pids = _runner_pids(algo.env_runner_group)
            if pids:
                victim = pids[int(rng.integers(len(pids)))]
                if _kill(victim):
                    killed.append(victim)
            stop.wait(0.6)

    t = threading.Thread(target=killer, daemon=True)
    try:
        within(120.0, algo.train)  # prime the stream before the storm
        t.start()
        steps = updates = 0
        for _ in range(5):
            r = within(120.0, algo.train)
            steps += r["num_env_steps_sampled"]
            updates += r["num_learner_updates"]
            assert r["num_learner_updates"] > 0
            assert np.isfinite(r["total_loss"])
        stop.set()
        t.join(timeout=10)
        assert killed, "the storm never landed a kill — proves nothing"
        group = algo.env_runner_group
        assert group.num_replacements > 0
        # quiet iterations after the storm: collecting the dead
        # runners' errored in-flight refs is what triggers their
        # replacement, so train until the fleet pings at full width
        for _ in range(8):
            r = within(120.0, algo.train)
            assert r["num_learner_updates"] > 0
            if group.ping_fleet(timeout=10.0) == group.num_runners:
                break
        assert group.ping_fleet(timeout=10.0) == group.num_runners
        # exact accounting: the ledger saw every consumed step exactly
        # once (record() raises on duplicates; unique == batches is the
        # structural echo of that)
        led = group.ledger.snapshot()
        assert led["unique"] == led["batches"]
        # every step the training loop counted is ledger-recorded; the
        # warmup iteration's consumption is included in the ledger, so
        # ledger >= storm-window sum, and both grow together
        assert led["env_steps"] >= steps
    finally:
        stop.set()
        t.join(timeout=10)
        algo.stop()


def _loss_trajectory(kill_iters, iters=6, seed=0):
    """A sync deterministic-replacement PPO run; SIGKILLs one runner
    before each iteration in `kill_iters`.  Returns (losses, steps,
    replacements, ledger)."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .training(lr=3e-4, minibatch_size=128, num_epochs=2,
                  deterministic_replacement=True)
        .debugging(seed=seed)
        .build()
    )
    losses, steps = [], []
    try:
        for i in range(iters):
            if i in kill_iters:
                pids = _runner_pids(algo.env_runner_group)
                if pids:
                    _kill(pids[i % len(pids)])
                    time.sleep(0.2)
            r = within(120.0, algo.train)
            losses.append(r["total_loss"])
            steps.append(r["num_env_steps_sampled"])
        return (losses, steps, algo.env_runner_group.num_replacements,
                algo.env_runner_group.ledger.snapshot())
    finally:
        algo.stop()


def test_kill_storm_matches_unkilled_control_run(cluster):
    """Deterministic replacement: the killed run replays each dead
    incarnation's weights history, so it consumes bit-identical sample
    batches — the loss trajectory EQUALS the unkilled control's, and
    per-iteration env-step accounting is exact in both."""
    control = _loss_trajectory(set())
    stormed = _loss_trajectory({1, 3})
    assert control[2] == 0
    assert stormed[2] >= 2, "kills never landed"
    # exact per-iteration accounting in both runs
    assert control[1] == stormed[1] == [2 * 4 * 32] * 6
    assert control[3]["unique"] == control[3]["batches"] == 12
    assert stormed[3]["unique"] == stormed[3]["batches"] == 12
    np.testing.assert_allclose(stormed[0], control[0], rtol=1e-5)

"""The JAX package's PPO-path cases of `tests/test_rllib.py`, on the
port (`ray_tpu_torch.rllib`), with the learner on the CPU
(`learners(device="cpu")`): environments, GAE, connectors and frame
stacking, the default module, the learner's update, its gang and DDP
actors, the runner fleet's object-plane refs, weights broadcast and
sample/train overlap, PPO learning CartPole on the sync, overlap and
compiled-DAG rounds at the reference's thresholds, checkpoints, pixel
Catch with the CNN encoder, a frame-stacked run, the fleet bench's row,
Pendulum's vector env and the gymnasium adapter (which skips only
where `gymnasium` is not installed).  The other algorithms' cases are
in `test_torch_rllib_vtrace.py`, `_replay.py` and `_offline.py`, the
chaos cases in `test_torch_chaos_rllib.py`.

One module-scoped port cluster serves every case (the JAX file's
fixture too).  What the runners run (connector factories) is defined
inside the case, as the JAX file does, so it travels by value and no
runner imports this module.  Every wait has a limit of its own: `timeout=` on each
`get`, `collect` and `wait`, and each training loop runs under
`within`, which fails the case when the loop outlives its limit.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import CartPoleVectorEnv, MLPModule, PPOConfig
from ray_tpu_torch.rllib.algorithms.ppo import compute_gae, ppo_loss
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import params_to_numpy
from test_torch_waits import within


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    yield
    rt.shutdown()


def _train(algo, iters, seconds=60.0):
    return within(seconds, lambda: [algo.train() for _ in range(iters)])


def _cartpole(**training):
    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .learners(device="cpu")
        .training(lr=3e-4, minibatch_size=256, num_epochs=4, **training)
        .debugging(seed=0)
    )


def _init_weights(module):
    import torch

    return params_to_numpy(module.init_params(
        torch.Generator().manual_seed(0)))


def test_cartpole_vector_env():
    env = CartPoleVectorEnv(num_envs=4, seed=0)
    obs = env.reset()
    assert obs.shape == (4, 4) and obs.dtype == np.float32
    total_done = 0
    for _ in range(600):
        obs, rew, term, trunc, info = env.step(np.ones(4, dtype=np.int64))
        assert rew.shape == (4,) and (rew == 1.0).all()
        done = term | trunc
        if done.any():
            assert "final_observation" in info
        total_done += int(done.sum())
        assert np.isfinite(obs).all()
    # always pushing right must topple the pole repeatedly (auto-reset)
    assert total_done > 4


def test_pendulum_vector_env():
    from ray_tpu_torch.rllib.env.envs import PendulumVectorEnv

    env = PendulumVectorEnv(num_envs=4, seed=0)
    assert env.continuous and env.action_dim == 1
    obs = env.reset()
    assert obs.shape == (4, 3)
    for _ in range(200):
        obs, rew, term, trunc, info = env.step(
            np.zeros((4, 1), np.float32)
        )
        assert (rew <= 0).all()  # Pendulum cost is always >= 0
        assert np.isfinite(obs).all()
    assert trunc.all() and "final_observation" in info  # 200-step limit


def test_gymnasium_vector_env_adapter():
    pytest.importorskip("gymnasium")
    from ray_tpu_torch.rllib.env.envs import GymnasiumVectorEnv

    env = GymnasiumVectorEnv("CartPole-v1", num_envs=2, seed=0)
    obs = env.reset()
    assert obs.shape == (2, 4)
    saw_final = False
    for _ in range(400):
        obs, rew, term, trunc, info = env.step(np.ones(2, dtype=np.int64))
        if (term | trunc).any():
            saw_final = "final_observation" in info
            break
    assert saw_final


def test_module_numpy_and_torch_forward_agree():
    import torch

    mod = MLPModule(4, 2, hidden=(16,))
    params = mod.init_params(torch.Generator().manual_seed(0))
    obs = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    tl, tv = mod.forward_train(params, torch.from_numpy(obs))
    nl, nv = mod.forward_numpy(params_to_numpy(params), obs)
    np.testing.assert_allclose(tl.numpy(), nl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), nv, rtol=1e-5, atol=1e-5)


def test_gae_matches_reference_recursion():
    rng = np.random.default_rng(0)
    terminated = rng.random((5, 3)) < 0.2
    truncated = (rng.random((5, 3)) < 0.15) & ~terminated
    sample = {
        "rewards": rng.normal(size=(5, 3)).astype(np.float32),
        "values": rng.normal(size=(5, 3)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated,
        "bootstrap_values": rng.normal(size=(5, 3)).astype(np.float32),
        "final_value": rng.normal(size=(3,)).astype(np.float32),
    }
    adv, tgt = compute_gae(sample, gamma=0.9, lambda_=0.8)
    # brute-force single-env recursion
    for b in range(3):
        gae = 0.0
        nv = sample["final_value"][b]
        for t in range(4, -1, -1):
            nonterm = 0.0 if terminated[t, b] else 1.0
            chain = nonterm * (0.0 if truncated[t, b] else 1.0)
            nv_eff = sample["bootstrap_values"][t, b] if truncated[t, b] else nv
            delta = (
                sample["rewards"][t, b] + 0.9 * nv_eff * nonterm
                - sample["values"][t, b]
            )
            gae = delta + 0.9 * 0.8 * chain * gae
            assert np.isclose(adv[t, b], gae, rtol=1e-5, atol=1e-5)
            nv = sample["values"][t, b]
    np.testing.assert_allclose(tgt, adv + sample["values"], rtol=1e-5)


def _synthetic_batch(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "logp": np.log(np.full(n, 0.5, np.float32)),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
        "clip_param": np.full(n, 0.2, np.float32),
        "vf_clip_param": np.full(n, 10.0, np.float32),
        "vf_loss_coeff": np.full(n, 0.5, np.float32),
        "entropy_coeff": np.full(n, 0.0, np.float32),
    }


def test_learner_update_reduces_loss():
    mod = MLPModule(4, 2, hidden=(32,))
    lrn = Learner(mod, ppo_loss, lr=1e-2, seed=0, device="cpu")
    batch = _synthetic_batch()
    first = lrn.update_minibatch(batch)["total_loss"]
    for _ in range(30):
        last = lrn.update_minibatch(batch)["total_loss"]
    assert last < first


def test_ppo_learns_cartpole(cluster):
    algo = _cartpole().build()
    try:
        results = _train(algo, 20)
        early = results[0]["episode_return_mean"]
        late = results[-1]["episode_return_mean"]
        assert np.isfinite(results[-1]["total_loss"])
        assert results[-1]["num_env_steps_sampled"] == 2 * 8 * 64
        # CartPole from-scratch: ~19 at init, >60 after 20 iterations
        assert late > max(40.0, early + 15.0), (early, late)
    finally:
        algo.stop()


def test_ppo_checkpoint_roundtrip(cluster, tmp_path):
    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .training(minibatch_size=128, num_epochs=1)
    )
    algo = cfg.build()
    try:
        _train(algo, 1)
        d = str(tmp_path / "ckpt")
        os.makedirs(d, exist_ok=True)
        algo.save_checkpoint(d)
        w_before = algo.learner_group.get_weights_numpy()
        state_before = algo.learner_group.get_state()

        algo2 = cfg.copy().build()
        try:
            algo2.load_checkpoint(d)
            w_after = algo2.learner_group.get_weights_numpy()
            np.testing.assert_allclose(
                w_before["pi"][0]["w"], w_after["pi"][0]["w"], rtol=1e-6
            )
            # the optimizer state came back too (optax's layout)
            state_after = algo2.learner_group.get_state()
            assert int(state_after["opt_state"]["count"]) == int(
                state_before["opt_state"]["count"]) > 0
            np.testing.assert_array_equal(
                state_after["opt_state"]["nu"]["vf"][0]["w"],
                state_before["opt_state"]["nu"]["vf"][0]["w"])
            assert algo2.iteration == algo.iteration == 1
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_mesh_sharded_learner_matches_local():
    """The learner over an explicit 8-device data mesh (equal row
    shards, gradients averaged before one step) produces the unsharded
    learner's update."""
    from ray_tpu_torch.rllib.core.learner import make_data_mesh

    mod = MLPModule(4, 2, hidden=(16,))
    local = Learner(mod, ppo_loss, lr=1e-2, seed=0, device="cpu")
    sharded = Learner(mod, ppo_loss, lr=1e-2, seed=0,
                      mesh=make_data_mesh(8, "cpu"))
    batch = _synthetic_batch(n=128)
    m1 = local.update_minibatch(batch)
    m2 = sharded.update_minibatch(batch)
    assert np.isclose(m1["total_loss"], m2["total_loss"], rtol=1e-4)
    w1 = local.get_weights_numpy()["pi"][0]["w"]
    w2 = sharded.get_weights_numpy()["pi"][0]["w"]
    np.testing.assert_allclose(w1, w2, rtol=1e-4, atol=1e-5)


def test_gang_learner_matches_local():
    """config.learners(num_learner_devices=N) builds the gang (a data
    mesh) internally; the sharded update is numerically the unsharded
    update."""
    from ray_tpu_torch.rllib.core.learner import LearnerGroup

    mod = MLPModule(4, 2, hidden=(16,))
    local = LearnerGroup(mod, ppo_loss, lr=1e-2, seed=0, device="cpu")
    gang = LearnerGroup(mod, ppo_loss, lr=1e-2, seed=0, gang_devices=4,
                        device="cpu")
    assert local.num_gang_devices == 1
    assert gang.num_gang_devices == 4
    batch = _synthetic_batch(n=128)
    m1 = local.update_minibatch(batch)
    m2 = gang.update_minibatch(batch)
    assert np.isclose(m1["total_loss"], m2["total_loss"], rtol=1e-4)
    w1 = local.get_weights_numpy()["pi"][0]["w"]
    w2 = gang.get_weights_numpy()["pi"][0]["w"]
    np.testing.assert_allclose(w1, w2, rtol=1e-4, atol=1e-5)


def test_gang_excludes_ddp_actors():
    from ray_tpu_torch.rllib.core.learner import LearnerGroup

    mod = MLPModule(4, 2, hidden=(16,))
    with pytest.raises(ValueError, match="alternative scaling"):
        LearnerGroup(mod, ppo_loss, num_learners=2, gang_devices=2,
                     device="cpu")


def test_sample_batches_travel_as_object_plane_refs(cluster):
    """The production path: sample_ref returns a small envelope whose
    batch payload is an ObjectRef into the producing actor's object
    plane — not an inline rollout — and the ledger records exactly
    once on fetch."""
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.rllib.core.rl_module import make_default_module
    from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup

    group = EnvRunnerGroup("CartPole-v1", 2, 4, 16, seed=0)
    try:
        spec = group.env_spec()
        module = make_default_module(spec, {"hidden": (16,)})
        group.sync_weights(_init_weights(module))
        ref = group._runners[0].sample_ref.remote(module)
        envelope = rt.get(ref, timeout=60)
        assert isinstance(envelope["batch"], ObjectRef)
        meta, batch = group.fetch(envelope)
        assert meta["env_steps"] == 16 * 4
        assert batch["obs"].shape[:2] == (16, 4)
        # exactly-once: consuming the same envelope again raises
        with pytest.raises(RuntimeError, match="duplicate"):
            group.fetch(envelope)
        led = group.ledger.snapshot()
        assert led["batches"] == led["unique"] == 1
        assert led["env_steps"] == 64
        assert led["bytes"] > 0
    finally:
        group.stop()


def test_weights_broadcast_pulls_once_per_version(cluster):
    """set_weights_ref is idempotent per version: a duplicate or stale
    broadcast is a no-op (each runner pulls the published object at
    most once per version)."""
    from ray_tpu_torch.rllib.env.env_runner import EnvRunner

    runner = rt.remote(EnvRunner).remote("CartPole-v1", 2, 8, seed=0)
    try:
        boxed_v1 = {"ref": rt.put({"w": np.ones(4, np.float32)},
                                  inline=False)}
        boxed_v2 = {"ref": rt.put({"w": np.zeros(4, np.float32)},
                                  inline=False)}
        get = lambda call: rt.get(call, timeout=60)  # noqa: E731
        assert get(runner.set_weights_ref.remote(boxed_v1, 1))
        assert not get(runner.set_weights_ref.remote(boxed_v1, 1))  # dup
        assert get(runner.set_weights_ref.remote(boxed_v2, 2))
        assert not get(runner.set_weights_ref.remote(boxed_v1, 1))  # stale
        assert get(runner.get_weights_version.remote()) == 2
    finally:
        rt.kill(runner)


def test_overlap_runners_sample_while_update_in_flight(cluster):
    """The async-overlap contract, proven directly: with the ref
    stream running, batches produced DURING a driver-side busy period
    (a learner update stand-in) are waiting in the object plane when
    the driver returns — zero blocking wait."""
    import time as _time

    from ray_tpu_torch.rllib.core.rl_module import make_default_module
    from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup

    group = EnvRunnerGroup("CartPole-v1", 2, 4, 16, seed=0)
    try:
        spec = group.env_spec()
        module = make_default_module(spec, {"hidden": (16,)})
        group.sync_weights(_init_weights(module))
        group.start_ref_stream(module, inflight_per_runner=2)
        # drain whatever the stream produced so far
        drained = group.collect(max_batches=64, timeout=60.0)
        t_mark = _time.time()
        _time.sleep(1.0)  # "the update": driver does no collecting
        # batches must be ALREADY waiting — a non-blocking sweep
        ready = group.collect(max_batches=64, block=False)
        assert ready, "no batches produced while the update ran"
        produced_during_update = [
            e for e in ready if e["meta"]["done_t"] > t_mark
        ]
        assert produced_during_update, (
            "ready batches all predate the update window"
        )
        for e in drained + ready:
            group.fetch(e)
        led = group.ledger.snapshot()
        assert led["unique"] == led["batches"] == len(drained) + len(ready)
    finally:
        group.stop()


def test_ppo_overlap_learns_cartpole(cluster):
    """End-to-end async overlap: PPO still learns, the result carries
    the measured overlap evidence, and accounting is exact."""
    algo = _cartpole(sample_train_overlap=True).build()
    try:
        results = _train(algo, 20)
        last = results[-1]
        assert np.isfinite(last["total_loss"])
        assert last["num_learner_updates"] > 0
        assert 0.0 <= last["overlap_ratio"] <= 1.0
        # steady state hides sampling behind the update: later
        # iterations' blocked wait is a small fraction of sample time
        waits = [r["sample_wait_s"] for r in results[5:]]
        busys = [r["sample_busy_s"] for r in results[5:]]
        assert sum(waits) < 0.5 * sum(busys), (sum(waits), sum(busys))
        led = algo.env_runner_group.ledger.snapshot()
        assert led["unique"] == led["batches"]
        assert led["env_steps"] == sum(
            r["num_env_steps_sampled"] for r in results
        )
        late = results[-1]["episode_return_mean"]
        early = results[0]["episode_return_mean"]
        assert late > max(40.0, early + 15.0), (early, late)
    finally:
        algo.stop()


def test_ppo_compiled_dag_learner_round(cluster):
    """use_compiled_dag=True: the learner round rides shm tensor
    channels into resident runner loops — no per-call actor RPCs on the
    sample hop or the weights broadcast — while PPO still learns and
    the exactly-once SampleLedger stays exact."""
    algo = _cartpole(sample_train_overlap=True,
                     use_compiled_dag=True).build()
    try:
        results = _train(algo, 20)
        last = results[-1]
        assert np.isfinite(last["total_loss"])
        assert last["num_learner_updates"] > 0
        assert 0.0 <= last["overlap_ratio"] <= 1.0
        # bounded staleness: runners drain to the newest weights at
        # every rollout boundary
        assert last["weights_staleness_mean"] < 8.0
        group = algo.env_runner_group
        assert group._chan_mode  # the channel plane actually engaged
        led = group.ledger.snapshot()
        assert led["unique"] == led["batches"]
        assert led["env_steps"] == sum(
            r["num_env_steps_sampled"] for r in results
        )
        # episode metrics rode the channel metas, not pop_metrics RPCs
        late = results[-1]["episode_return_mean"]
        early = results[0]["episode_return_mean"]
        assert late > max(40.0, early + 15.0), (early, late)
    finally:
        algo.stop()
    # teardown released every ring: the sweeper finds nothing stale
    from ray_tpu_torch import shm as shm_mod

    assert shm_mod.sweep_stale_segments() == []
    assert not group._chan_mode


def test_compiled_dag_config_validation():
    """use_compiled_dag composes only with the overlap round, and not
    with replay-based determinism or connector pipelines."""
    with pytest.raises(ValueError, match="sample_train_overlap"):
        PPOConfig().environment("CartPole-v1").training(
            use_compiled_dag=True
        ).build()
    with pytest.raises(ValueError, match="deterministic_replacement"):
        PPOConfig().environment("CartPole-v1").training(
            use_compiled_dag=True, sample_train_overlap=True,
            deterministic_replacement=True,
        ).build()


def test_multi_learner_ddp_runs(cluster):
    """Two DDP learner actors on the CPU: every rank applies the same
    allreduced gradient, so their weights stay equal."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(num_learners=2)
        .training(minibatch_size=64, num_epochs=1)
        .build()
    )
    try:
        r = _train(algo, 1)[0]
        assert np.isfinite(r["total_loss"])
        a, b = (rt.get(x.get_weights_numpy.remote(), timeout=60)
                for x in algo.learner_group._actors)
        np.testing.assert_array_equal(a["pi"][0]["w"], b["pi"][0]["w"])
    finally:
        algo.stop()


# ----------------------------------------------------------------------
# connectors (reference: rllib/connectors/ ConnectorV2 pipelines)
# ----------------------------------------------------------------------
def test_mean_std_filter_normalizes_and_merges():
    from ray_tpu_torch.rllib.connectors import MeanStdObsFilter

    rng = np.random.default_rng(0)
    f = MeanStdObsFilter()
    data = rng.normal(loc=5.0, scale=3.0, size=(2000, 4)).astype(np.float32)
    out = None
    for i in range(0, 2000, 100):
        out = f.on_observations(data[i:i + 100])
    # converged normalizer: recent outputs near zero mean / unit std
    assert abs(out.mean()) < 0.3
    assert 0.7 < out.std() < 1.3
    # exact parallel merge: two filters over halves == one over all
    a, b = MeanStdObsFilter(), MeanStdObsFilter()
    a.on_observations(data[:1000])
    b.on_observations(data[1000:])
    merged = MeanStdObsFilter.merge_states([a.get_state(), b.get_state()])
    whole = MeanStdObsFilter()
    whole.on_observations(data)
    w = whole.get_state()  # get_state POPS: capture once
    np.testing.assert_allclose(merged["mean"], w["mean"], rtol=1e-10)
    np.testing.assert_allclose(merged["m2"], w["m2"], rtol=1e-8)
    assert merged["count"] == 2000


def test_connector_pipeline_composition():
    from ray_tpu_torch.rllib.connectors import (
        ConnectorPipeline, ObsClip, RewardClip,
    )

    pipe = ConnectorPipeline([ObsClip(bound=1.0), RewardClip(bound=0.5)])
    obs = pipe.on_observations(np.array([[3.0, -3.0]], np.float32))
    np.testing.assert_allclose(obs, [[1.0, -1.0]])
    rew = pipe.on_rewards(np.array([2.0, -2.0], np.float32))
    np.testing.assert_allclose(rew, [0.5, -0.5])
    state = pipe.get_state()
    pipe.set_state(state)  # roundtrip is a no-op for stateless stages


def test_ppo_with_obs_normalization_connector(cluster):
    """The connector rides into remote runners (factory-shipped), the
    rollout stores transformed observations, and fleet states merge
    each iteration; PPO still learns."""
    from ray_tpu_torch.rllib.connectors import (
        ConnectorPipeline,
        MeanStdObsFilter,
    )

    def connector():
        return ConnectorPipeline([MeanStdObsFilter(clip=5.0)])

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=64,
                     env_to_module_connector=connector)
        .learners(device="cpu")
        .training(lr=3e-4, minibatch_size=256, num_epochs=4)
        .debugging(seed=0)
        .build()
    )
    try:
        results = _train(algo, 10)
        assert np.isfinite(results[-1]["total_loss"])
        # normalizer stats accumulated and synced across the fleet:
        # count tracks TRUE sample totals (2 runners x 8 envs x 64
        # steps x 10 iters ~= 10k) — the delta protocol must not
        # double-count shared history across syncs
        merged = algo.env_runner_group.sync_connector_states()
        stats = merged["0"]
        assert 9_000 < stats["count"] < 25_000, stats["count"]
        assert (np.abs(stats["mean"]) < 2.0).all()
        late = results[-1]["episode_return_mean"]
        assert late > results[0]["episode_return_mean"] - 10, (
            results[0]["episode_return_mean"], late)
    finally:
        algo.stop()


def test_mean_std_filter_delta_protocol_no_double_count():
    """Repeated sync cycles must grow count LINEARLY with new samples:
    get_state reports only the delta since the last set_state."""
    from ray_tpu_torch.rllib.connectors import MeanStdObsFilter

    rng = np.random.default_rng(3)
    f = MeanStdObsFilter()
    base = {}
    for cycle in range(5):
        f.on_observations(rng.normal(size=(100, 4)).astype(np.float32))
        delta = f.get_state()
        assert delta["count"] == 100  # only the new samples
        base = MeanStdObsFilter.merge_states([base, delta])
        f.set_state(base)
    assert base["count"] == 500  # linear, not exponential
    rng = np.random.default_rng(3)
    whole = MeanStdObsFilter()
    for _ in range(5):
        whole.on_observations(rng.normal(size=(100, 4)).astype(np.float32))
    w = whole.get_state()
    np.testing.assert_allclose(base["mean"], w["mean"], rtol=1e-10)
    np.testing.assert_allclose(base["m2"], w["m2"], rtol=1e-8)


# ----------------------------------------------------------------------
# pixels (reference: rllib/env/wrappers/atari_wrappers.py)
# ----------------------------------------------------------------------
def test_catch_pixel_env():
    from ray_tpu_torch.rllib.env.envs import CatchPixelEnv

    env = CatchPixelEnv(num_envs=4, seed=0)
    obs = env.reset()
    assert obs.shape == (4, 10, 5, 1) and obs.dtype == np.float32
    assert env.observation_shape == (10, 5, 1)
    total_reward = 0.0
    for _ in range(27):  # 3 episodes of 9 steps
        obs, rew, term, trunc, info = env.step(np.ones(4, np.int64))
        # exactly a ball and a paddle pixel per frame (may overlap)
        on = obs.reshape(4, -1).sum(axis=1)
        assert ((on == 2.0) | (on == 1.0)).all()
        if term.any():
            assert "final_observation" in info
            total_reward += rew[term].sum()
    assert total_reward != 0.0  # catches/misses actually scored


def test_cnn_module_torch_numpy_parity():
    import torch

    from ray_tpu_torch.rllib.core.rl_module import CNNModule

    m = CNNModule((10, 5, 1), 3, conv_filters=((8, 3, 2), (16, 3, 2)),
                  hidden=(32,))
    params = m.init_params(torch.Generator().manual_seed(0))
    obs = np.random.default_rng(0).random((6, 10, 5, 1), dtype=np.float32)
    lt, vt = m.forward_train(params, torch.from_numpy(obs))
    ln, vn = m.forward_numpy(params_to_numpy(params), obs)
    np.testing.assert_allclose(lt.numpy(), ln, atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), vn, atol=1e-4)


def test_make_default_module_picks_cnn_for_images():
    from ray_tpu_torch.rllib.core.rl_module import (
        CNNModule, MLPModule, make_default_module,
    )

    cnn = make_default_module(
        {"observation_size": 50, "observation_shape": (10, 5, 1),
         "num_actions": 3}, {})
    assert isinstance(cnn, CNNModule)
    mlp = make_default_module(
        {"observation_size": 4, "observation_shape": (4,),
         "num_actions": 2}, {})
    assert isinstance(mlp, MLPModule)
    with pytest.raises(ValueError, match="discrete action spaces only"):
        make_default_module({"observation_size": 2, "continuous": True,
                             "action_dim": 1, "num_actions": 0}, {})


def test_image_preprocess_connector():
    from ray_tpu_torch.rllib.connectors import ImagePreprocess

    c = ImagePreprocess(size=8, grayscale=True)
    assert c.transformed_observation_shape((21, 16, 3)) == (8, 8, 1)
    frames = np.full((2, 21, 16, 3), 255.0, np.float32)
    out = c.on_observations(frames)
    assert out.shape == (2, 8, 8, 1)
    np.testing.assert_allclose(out, 1.0, atol=1e-5)  # 255 -> 1.0 gray


def test_frame_stack_connector_semantics():
    from ray_tpu_torch.rllib.connectors import FrameStack

    fs = FrameStack(3)
    assert fs.transformed_observation_shape((4, 4, 1)) == (4, 4, 3)
    f = lambda v: np.full((2, 4, 4, 1), float(v), np.float32)  # noqa: E731
    # first obs repeats into all k slots
    s1 = fs.on_observations(f(1))
    np.testing.assert_array_equal(s1[..., 0], f(1)[..., 0])
    np.testing.assert_array_equal(s1[..., 2], f(1)[..., 0])
    # second obs shifts: [1, 1, 2]
    s2 = fs.on_observations(f(2))
    assert s2[0, 0, 0, 1] == 1.0 and s2[0, 0, 0, 2] == 2.0
    # bootstrap/final path stacks WITHOUT advancing state
    fin = fs.on_final_observations(f(9)[:1], np.array([0]))
    assert fin[0, 0, 0, 2] == 9.0
    s3 = fs.on_observations(f(3))
    assert s3[0, 0, 0, 2] == 3.0 and s3[0, 0, 0, 1] == 2.0
    assert (s3[..., 0] == 1.0).all()  # the 9 never entered the buffer
    # episode boundary: env 0 resets, env 1 keeps its stack
    fs.on_episode_boundaries(np.array([True, False]))
    s4 = fs.on_observations(f(4))
    assert (s4[0, ..., 0] == 4.0).all()  # fresh stack = repeat
    assert s4[1, 0, 0, 0] == 2.0  # old history retained


def test_frame_stack_multichannel_layout():
    """Stacks are whole-frame blocks [f1|f2|f3], never per-channel
    interleaving — a regression guard for multi-channel (RGB) frames."""
    from ray_tpu_torch.rllib.connectors import FrameStack

    fs = FrameStack(2)
    f1 = np.zeros((1, 2, 2, 2), np.float32)
    f1[..., 0], f1[..., 1] = 1.0, 2.0  # frame1 channels (a=1, b=2)
    f2 = np.zeros((1, 2, 2, 2), np.float32)
    f2[..., 0], f2[..., 1] = 3.0, 4.0
    s1 = fs.on_observations(f1)
    np.testing.assert_array_equal(s1[0, 0, 0], [1, 2, 1, 2])  # [f1|f1]
    s2 = fs.on_observations(f2)
    np.testing.assert_array_equal(s2[0, 0, 0], [1, 2, 3, 4])  # [f1|f2]
    # reset path keeps block layout too
    fs.on_episode_boundaries(np.array([True]))
    s3 = fs.on_observations(f1)
    np.testing.assert_array_equal(s3[0, 0, 0], [1, 2, 1, 2])


def test_ppo_learns_pixel_catch(cluster):
    """BASELINE config #3 analog: PPO with the CNN encoder learns a
    pixel env end-to-end (ALE isn't installable here; Catch is the
    procedural stand-in)."""
    from ray_tpu_torch.rllib.core.rl_module import CNNModule

    cfg = (PPOConfig()
           .environment("Catch-v0")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=16,
                        rollout_fragment_length=32)
           .learners(device="cpu")
           .training(lr=1e-3, minibatch_size=256, num_epochs=4,
                     model={"conv_filters": ((16, 3, 2), (32, 3, 2)),
                            "hidden": (128,)})
           .debugging(seed=0))
    algo = cfg.build()
    try:
        assert isinstance(algo.module, CNNModule)

        def learn():
            best = -1.0
            for _ in range(45):
                ret = algo.train().get("episode_return_mean")
                if ret is not None and np.isfinite(ret):
                    best = max(best, ret)
                if best > 0.6:
                    break
            return best

        best = within(120.0, learn)
        # random play scores about -0.6; a learned paddle catches most
        assert best > 0.4, best
    finally:
        algo.stop()


def test_frame_stacked_ppo_runs(cluster):
    """The full Atari-style connector pipeline (preprocess + stack +
    reward clip) rides through remote runners and the learner trains on
    stacked frames."""
    from ray_tpu_torch.rllib.connectors import wrap_atari_connectors

    def conn():
        return wrap_atari_connectors(size=10, grayscale=False,
                                     frame_stack=2, clip_rewards=True)

    cfg = (PPOConfig()
           .environment("Catch-v0")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                        rollout_fragment_length=16,
                        env_to_module_connector=conn)
           .learners(device="cpu")
           .training(lr=1e-3, minibatch_size=128, num_epochs=2,
                     model={"conv_filters": ((8, 3, 2),), "hidden": (64,)})
           .debugging(seed=0))
    algo = cfg.build()
    try:
        spec = algo.env_runner_group.env_spec()
        assert spec["observation_shape"] == (10, 10, 2)
        r = _train(algo, 1)[0]
        assert np.isfinite(r["total_loss"])
    finally:
        algo.stop()


def test_fleet_bench_row_accounts_exactly(cluster):
    """The fleet bench's row at a small shape (its numbers are the
    chip's to give): both headline metrics present, every env step the
    loop counted ledger-recorded exactly once, the overlap ran."""
    from ray_tpu_torch.rllib import bench

    row = within(60.0, lambda: bench._run_mode(
        PPOConfig, True, 2, 4, 16, 64, 1, 1, 2, 0, device="cpu"))
    assert row["env_steps_per_s"] > 0 and row["updates_per_s"] > 0
    assert row["accounting_exact"] == 1.0
    assert row["env_steps"] == row["ledger_env_steps"] > 0
    assert row["overlap"] == 1.0 and row["gang_devices"] == 1.0
    assert 0.0 <= row["overlap_ratio"] <= 1.0

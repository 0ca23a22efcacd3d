"""The port's multi-agent PPO (`ray_tpu_torch.rllib.algorithms.
multi_agent_ppo` over `rllib/env/multi_agent.py`) against the JAX
package's on the CPU, and the reference's cases for it on the port with
the learners on the CPU.

Parity, on the same seeded numpy inputs: the runner's demultiplexing
(a policy a module, and one shared policy whose agents' rows
interleave) and `multi_agent_gae` exact against the originals (copies)
and the GAE against the reference test's brute force; each module's
first learner update against JAX's learner from JAX's state (metrics
1e-5, params rtol 1e-5 / atol 1e-6, rounding-level gradients' elements
within 2 lr); one `train()` of both packages from the same learner
states: the runners' samples bit-equal, then the iteration's metrics
and weights at 1e-5.  Then the reference's coordination and shared-
policy cases (`tests/test_rllib.py:675-712`) with their gates, and a
`get_state` / `set_state` round trip.  Every wait has a limit
(`within`).
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu as jrt
import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import multi_agent_ppo as jmappo
from ray_tpu.rllib.algorithms.ppo import make_ppo_loss as jmake_loss
from ray_tpu.rllib.core.learner import Learner as JLearner
from ray_tpu.rllib.core.rl_module import MLPModule as JMLP
from ray_tpu.rllib.env import multi_agent as jma
from ray_tpu_torch.rllib.algorithms import multi_agent_ppo as tmappo
from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss as tmake_loss
from ray_tpu_torch.rllib.core.learner import Learner as TLearner
from ray_tpu_torch.rllib.core.rl_module import MLPModule as TMLP
from ray_tpu_torch.rllib.env import multi_agent as tma
from test_torch_rllib import _noisy, _np, _port_state, _tree_close
from test_torch_waits import within

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
TWO = {"agent_0": "pol_a", "agent_1": "pol_b"}
SHARED = {"agent_0": "shared", "agent_1": "shared"}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    yield
    rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The learners' ops are tiny (64-wide towers): on a shared CPU,
    PyTorch's intra-op threads cost 15-25x a single thread's time for
    them, and the parallel test run's other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mapping_fn(aid):
    return "pol_a" if aid == "agent_0" else "pol_b"


# ----------------------------------------------------------------------
# the runner and the GAE (copies)
# ----------------------------------------------------------------------
def _runner_pair(mapping, T=20, seed=3, hidden=(16,)):
    """Both packages' runners on the coordination game, each module's
    weights JAX's init (numpy), sampled once."""
    out = []
    params = None
    for ma, mlp in ((jma, JMLP), (tma, TMLP)):
        runner = ma.MultiAgentEnvRunner(ma.CoordinationGame, T, mapping,
                                        seed=seed)
        spec = runner.env_spec()
        modules = {m: mlp(spec["observation_size"], spec["num_actions"],
                          hidden=hidden) for m in spec["module_ids"]}
        if params is None:
            params = {m: _np(JMLP(2, 2, hidden=hidden).init_params(
                jax.random.PRNGKey(i + 1))) for i, m in enumerate(modules)}
        runner.set_weights(params, 1)
        out.append((spec, runner.sample(modules), runner.pop_metrics()))
    return out


@pytest.mark.parametrize("mapping", [TWO, SHARED], ids=["two", "shared"])
def test_runner_demultiplexes_like_the_original(mapping):
    """The reference test's case (tests/test_rllib.py:592-620) on the
    port, and its samples bit-equal to the original runner's from the
    same weights and seed: a module per policy, or one shared module
    whose two agents interleave a row each per step (`agent_lane`)."""
    (jspec, jout, jeps), (tspec, tout, teps) = _runner_pair(mapping)
    assert tspec == jspec
    assert tspec["module_ids"] == sorted(set(mapping.values()))
    assert set(tout) == set(jout) == set(mapping.values())
    per_module = 20 * 2 // len(tout)
    for mid, batch in tout.items():
        assert set(batch) == set(jout[mid])
        for k, v in batch.items():
            assert v.dtype == jout[mid][k].dtype, k
            np.testing.assert_array_equal(v, jout[mid][k], err_msg=k)
        assert len(batch["actions"]) == per_module
        assert batch["obs"].shape == (per_module, tspec["observation_size"])
        assert batch["dones"].sum() >= 1  # episodes of length 10
    if mapping is SHARED:
        np.testing.assert_array_equal(tout["shared"]["agent_lane"],
                                      np.tile([0, 1], 20))
    assert teps == jeps and len(teps) == 2


def _single_lane_gae(rewards, values, dones, gamma, lam):
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    gae, next_value = 0.0, 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    return adv


def test_multi_agent_gae_matches_the_original_and_the_brute_force():
    """The reference test's case (tests/test_rllib.py:638-672): rows of
    two agents interleaved, the recursion chained within a lane; the
    port's GAE bit-equal to the original's, with lanes and without."""
    rng = np.random.default_rng(0)
    T, gamma, lam = 12, 0.9, 0.8
    lanes = {}
    for lane in (0, 1):
        dones = np.zeros(T, np.bool_)
        dones[5] = dones[T - 1] = True
        lanes[lane] = {
            "rewards": rng.normal(size=T).astype(np.float32),
            "values": rng.normal(size=T).astype(np.float32),
            "dones": dones,
        }
    batch = {
        k: np.stack([lanes[lane][k][t] for t in range(T)
                     for lane in (0, 1)])
        for k in ("rewards", "values", "dones")
    }
    batch["agent_lane"] = np.array([lane for _ in range(T)
                                    for lane in (0, 1)], np.int32)
    adv, tgt = tma.multi_agent_gae(batch, gamma, lam)
    for lane in (0, 1):
        expect = _single_lane_gae(
            lanes[lane]["rewards"], lanes[lane]["values"],
            lanes[lane]["dones"], gamma, lam,
        )
        np.testing.assert_allclose(adv[lane::2], expect, rtol=1e-5)
    np.testing.assert_allclose(tgt, adv + batch["values"], rtol=1e-6)
    flat = {k: v for k, v in batch.items() if k != "agent_lane"}
    for b in (batch, flat):
        for got, want in zip(tma.multi_agent_gae(b, gamma, lam),
                             jma.multi_agent_gae(b, gamma, lam)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_unknown_env_and_module_ids_fail_as_the_original():
    with pytest.raises(ValueError, match="unknown multi-agent env"):
        tma.make_multi_agent_env("nope")
    cfg = (tmappo.MultiAgentPPOConfig().learners(device="cpu")
           .multi_agent(policies=["pol_a"], policy_mapping_fn=_mapping_fn))
    with pytest.raises(ValueError, match="not in policies"):
        cfg.build()


# ----------------------------------------------------------------------
# the learners
# ----------------------------------------------------------------------
def _module_minibatch(mid, mapping=TWO, n=128):
    """A module's PPO minibatch as `training_step` builds it: two
    runners' rollouts of 100 steps, GAE a rollout, normalised
    advantages, the first `n` rows of a seeded permutation."""
    batches = []
    for i in range(2):
        runner = tma.MultiAgentEnvRunner("coordination", 100, mapping,
                                         seed=i * 10_000)
        params = {m: _np(JMLP(2, 2).init_params(jax.random.PRNGKey(j)))
                  for j, m in enumerate(sorted(set(mapping.values())))}
        runner.set_weights(params, 1)
        batches.append(runner.sample({m: TMLP(2, 2) for m in params})[mid])
    adv, tgt = zip(*(tma.multi_agent_gae(b, 0.99, 0.95) for b in batches))
    adv = np.concatenate(adv)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    idx = np.random.default_rng(0).permutation(len(adv))[:n]
    return {"obs": np.concatenate([b["obs"] for b in batches])[idx],
            "actions": np.concatenate([b["actions"] for b in batches])[idx],
            "logp": np.concatenate([b["logp"] for b in batches])[idx],
            "advantages": adv[idx],
            "value_targets": np.concatenate(tgt)[idx]}


@pytest.mark.parametrize("i,mid", [(0, "pol_a"), (1, "pol_b")])
def test_first_update_of_each_module_matches_jax(i, mid):
    """Each module's learner as `setup_components` builds it (the PPO
    loss with the config's clip, value and entropy coefficients, lr
    3e-3 as the coordination case trains, grad clip 0.5, seed + i): the
    port's first update from JAX's state on the module's minibatch."""
    cfg = tmappo.MultiAgentPPOConfig()
    kw = dict(vf_loss_coeff=cfg.vf_loss_coeff,
              entropy_coeff=cfg.entropy_coeff)
    jloss, tloss = (jmake_loss(cfg.clip_param, **kw),
                    tmake_loss(cfg.clip_param, **kw))
    lr = 3e-3
    jl = JLearner(JMLP(2, 2), jloss, lr=lr, grad_clip=cfg.grad_clip,
                  seed=cfg.seed + i)
    tl = TLearner(TMLP(2, 2), tloss, lr=lr, grad_clip=cfg.grad_clip,
                  seed=cfg.seed + i, device="cpu")
    tl.set_state(_port_state(jl.get_state()))
    batch = _module_minibatch(mid)
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(JMLP(2, 2), p, b), has_aux=True))(jl.params,
                                                            batch)
    noisy = _noisy(jg)
    jm = jl.update_minibatch(batch)
    tm = tl.update_minibatch(batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
    assert abs(jm["policy_loss"]) > 0 and jm["entropy"] > 0.5
    for g, w, n in zip(jax.tree.leaves(tl.get_weights_numpy()),
                       jax.tree.leaves(_np(jl.params)), noisy):
        np.testing.assert_allclose(g[~n], w[~n], **PARAM_TOL)
        np.testing.assert_allclose(g[n], w[n], rtol=0, atol=2 * lr)


# ----------------------------------------------------------------------
# one training step of both packages
# ----------------------------------------------------------------------
def _config(cls):
    cfg = cls()
    cfg.environment("coordination", env_config={"episode_len": 10})
    cfg.env_runners(num_env_runners=2, rollout_fragment_length=50)
    cfg.training(lr=3e-3, minibatch_size=64, num_epochs=2)
    cfg.multi_agent(policies=["pol_a", "pol_b"],
                    policy_mapping_fn=_mapping_fn)
    return cfg


def _sample_and_train(algo, runtime):
    samples = [within(60.0, lambda r=r: runtime.get(
        r.sample.remote(algo.modules), timeout=60)) for r in algo._runners]
    result = within(120.0, algo.train)
    return samples, result, algo._weights()


def test_one_training_step_matches_jax():
    """Both packages from the same learner states (the port's set from
    JAX's): each runner's first rollout bit-equal; then one `train()`
    (a second rollout, the GAE, 2 epochs of 64-row minibatches a
    module, the weights back to the runners): the same env steps and
    episode returns, every module's metrics and weights at 1e-5."""
    jrt.init(num_workers=2, num_cpus=4, ignore_reinit_error=True)
    try:
        jalgo = _config(jmappo.MultiAgentPPOConfig).build()
        try:
            start = {m: lg.get_state() for m, lg in jalgo.learners.items()}
            jsamples, jres, jweights = _sample_and_train(jalgo, jrt)
        finally:
            jalgo.stop()
    finally:
        jrt.shutdown()
    rt.init(num_workers=2, num_cpus=4, ignore_reinit_error=True)
    try:
        talgo = _config(tmappo.MultiAgentPPOConfig).learners(
            device="cpu").build()
        try:
            for mid, lg in talgo.learners.items():
                assert lg.device == torch.device("cpu")
                lg.set_state(_port_state(start[mid]))
            talgo._sync_weights()
            tsamples, tres, tweights = _sample_and_train(talgo, rt)
        finally:
            talgo.stop()
    finally:
        rt.shutdown()
    for got, want in zip(tsamples, jsamples):
        assert set(got) == set(want) == {"pol_a", "pol_b"}
        for mid in want:
            for k in want[mid]:
                np.testing.assert_array_equal(got[mid][k], want[mid][k],
                                              err_msg=f"{mid}/{k}")
    assert tres["num_env_steps_sampled"] == jres["num_env_steps_sampled"]
    assert tres["num_env_steps_sampled"] == 2 * 2 * 50
    keys = {k for k in jres if "/" in k}
    assert keys == {k for k in tres if "/" in k} and len(keys) == 10
    for k in sorted(keys) + ["episode_return_mean"]:
        np.testing.assert_allclose(tres[k], jres[k], err_msg=k, **TOL)
    _tree_close(tweights, jweights)


# ----------------------------------------------------------------------
# the reference's cases, on the port
# ----------------------------------------------------------------------
def test_multi_agent_ppo_learns_coordination(cluster):
    """tests/test_rllib.py:675-695 with the learners on the CPU: uniform
    independent play earns ~5 of 10; 15 iterations must pass 7."""
    cfg = _config(tmappo.MultiAgentPPOConfig)
    cfg.env_runners(num_env_runners=2, rollout_fragment_length=200)
    cfg.training(lr=3e-3, minibatch_size=128, num_epochs=4)
    cfg.learners(device="cpu")
    algo = cfg.build()
    try:
        results = within(120.0, lambda: [algo.train() for _ in range(15)])
        late = results[-1]["episode_return_mean"]
        assert late > 7.0, late
        assert any(k.startswith("pol_a/") for k in results[-1])
        assert any(k.startswith("pol_b/") for k in results[-1])
    finally:
        algo.stop()


def test_multi_agent_shared_policy(cluster):
    """tests/test_rllib.py:698-712: the default mapping puts both agents
    on one "shared" module, whose batch holds both agents' rows."""
    cfg = tmappo.MultiAgentPPOConfig()
    cfg.environment("coordination")
    cfg.env_runners(num_env_runners=1, rollout_fragment_length=100)
    cfg.training(minibatch_size=64, num_epochs=2)
    cfg.learners(device="cpu")
    algo = cfg.build()
    try:
        r = within(60.0, algo.train)
        assert r["num_env_steps_sampled"] == 2 * 100  # 2 agents x T
        assert any(k.startswith("shared/") for k in r)
        assert list(algo.learners) == ["shared"]
    finally:
        algo.stop()


def test_state_round_trip(cluster):
    """`get_state` after an iteration, restored after another: every
    module's params and Adam state, the recent returns and the
    iteration come back, and the runners receive the restored
    weights."""
    cfg = _config(tmappo.MultiAgentPPOConfig).learners(device="cpu")
    algo = cfg.build()
    try:
        within(60.0, algo.train)
        state = algo.get_state()
        within(60.0, algo.train)
        moved = algo._weights()
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(moved), jax.tree.leaves(
                {m: s["params"] for m, s in state["learners"].items()})))
        version = algo._weights_version
        algo.set_state(state)
        assert algo.iteration == state["iteration"] == 1
        assert algo._recent_returns == state["recent_returns"]
        assert algo._weights_version == version + 1
        for mid, lg in algo.learners.items():
            got = lg.get_state()
            for g, w in zip(jax.tree.leaves(got),
                            jax.tree.leaves(state["learners"][mid])):
                np.testing.assert_array_equal(g, w)
        r = within(60.0, algo.train)
        assert np.isfinite(r["pol_a/total_loss"])
    finally:
        algo.stop()

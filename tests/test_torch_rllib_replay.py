"""The port's replay algorithms (`ray_tpu_torch.rllib`: DQN, and SAC
discrete and continuous) against the JAX package's on the CPU, and the
reference's cases for them on the port with the learner on the CPU.

Parity, on the same seeded numpy inputs and params bridged from JAX's
`init_params` (`test_torch_rllib_vtrace.py`'s helpers and limits):
`ReplayBuffer`, `_transitions` and the runners' action selection exact
(copies); each loss and its gradient at f32 1e-5 (SAC's continuous loss
on the same reparameterisation draw, `batch["noise"]`); one update
against JAX's learner; each loss's gang form against the whole batch;
and the TD targets — the reference's jitted target forwards
(`DQN._target_q`, `SAC._target_terms`) against the port's eager
no-grad forwards on the target params it keeps on the learner's
device — at 1e-5, through each algorithm's own `_td_targets`.  The
target cases build both packages' algorithms over a local stand-in for
the runner group (`_LocalGroup`: an in-process runner answers
`env_spec`), so no runtime boots for them.  The runners get
`ContinuousTargetEnv` itself (the package's class, pickled by
reference), never a factory of this module: a runner would import the
module, and JAX with it.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.env import env_runner as jrunner
from ray_tpu.rllib.env import env_runner_group as jgroup
from ray_tpu.rllib.env.envs import ContinuousTargetEnv as JTargetEnv
from ray_tpu_torch.models.bridge import tree_leaves
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.env import env_runner as trunner
from ray_tpu_torch.rllib.env import env_runner_group as tgroup
from ray_tpu_torch.rllib.env.envs import ContinuousTargetEnv as TTargetEnv
from test_torch_rllib import _port_state
from test_torch_rllib_vtrace import _gang_parity, _loss_parity, _update_parity
from test_torch_waits import within

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _train(algo, iters, seconds=120.0):
    return within(seconds, lambda: [algo.train() for _ in range(iters)])


# ----------------------------------------------------------------------
# the numpy copies
# ----------------------------------------------------------------------
def _rollout(T=6, B=4, obs_dim=3, continuous=False, seed=0):
    rng = np.random.default_rng(seed)
    terminated = rng.random((T, B)) < 0.2
    actions = (rng.normal(size=(T, B, 2)).astype(np.float32) if continuous
               else rng.integers(0, 3, (T, B)).astype(np.int64))
    return {
        "obs": rng.normal(size=(T, B, obs_dim)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "terminated": terminated,
        "truncated": (rng.random((T, B)) < 0.2) & ~terminated,
        "final_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
    }


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_transitions_and_replay_buffer_equal_the_originals(continuous):
    """`_transitions` flattens a rollout as the original does, and two
    buffers (capacity 20, so the ring wraps) filled alike sample the
    same rows for the same generator state."""
    kw = (dict(action_shape=(2,), action_dtype=np.float32) if continuous
          else {})
    tb, jb = (tdqn.ReplayBuffer(20, 3, **kw), jdqn.ReplayBuffer(20, 3, **kw))
    for seed in range(3):
        s = _rollout(continuous=continuous, seed=seed)
        got, want = tdqn._transitions(s), jdqn._transitions(s)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        tb.add_batch(*got)
        jb.add_batch(*want)
    assert len(tb) == len(jb) == 20 and tb._next == jb._next
    got = tb.sample(32, np.random.default_rng(7))
    want = jb.sample(32, np.random.default_rng(7))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_runner_action_selection_equals_the_original():
    """The runners' numpy policies (DQN's epsilon-greedy, continuous
    SAC's squashed Gaussian) draw what the originals draw from the same
    generator state."""
    obs = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    for tmod, jmod in ((tdqn.QMLPModule(4, 3, hidden=(8,)),
                        jdqn.QMLPModule(4, 3, hidden=(8,))),
                       (tsac.ContinuousSACModule(4, 2, hidden=(8,)),
                        jsac.ContinuousSACModule(4, 2, hidden=(8,)))):
        params = jax.tree.map(np.asarray,
                              jmod.init_params(jax.random.PRNGKey(0)))
        for explore in (0.3, None, False):
            got = tmod.select_actions_numpy(
                params, obs, np.random.default_rng(1), explore)
            want = jmod.select_actions_numpy(
                params, obs, np.random.default_rng(1), explore)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# the losses, the update, the gang
# ----------------------------------------------------------------------
def _modules(which, hidden=(16, 16)):
    if which == "dqn":
        return (jdqn.QMLPModule(4, 3, hidden=hidden),
                tdqn.QMLPModule(4, 3, hidden=hidden))
    if which == "sac_discrete":
        return (jsac.SACModule(4, 3, hidden=hidden),
                tsac.SACModule(4, 3, hidden=hidden))
    return (jsac.ContinuousSACModule(4, 2, hidden=hidden),
            tsac.ContinuousSACModule(4, 2, hidden=hidden))


LOSSES = {
    "dqn": (jdqn.make_dqn_loss, tdqn.make_dqn_loss),
    "sac_discrete": (lambda: jsac.make_sac_loss(0.5 * np.log(3)),
                     lambda: tsac.make_sac_loss(0.5 * np.log(3))),
    "sac_continuous": (lambda: jsac.make_continuous_sac_loss(-2.0),
                       lambda: tsac.make_continuous_sac_loss(-2.0)),
}


def _batch(which, n=128, seed=0):
    """TD targets spread so that DQN's Huber loss sees errors on both
    sides of 1; SAC's continuous batch carries actions in (-1, 1) and
    the reparameterisation draw."""
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "td_target": (rng.normal(size=n) * 2).astype(np.float32)}
    if which == "sac_continuous":
        batch["actions"] = np.tanh(rng.normal(size=(n, 2))).astype(
            np.float32)
        batch["noise"] = rng.standard_normal((n, 2)).astype(np.float32)
    else:
        batch["actions"] = rng.integers(0, 3, n).astype(np.int32)
    return batch


def _start_params(jmod, seed):
    """JAX's init, with a nonzero `log_alpha` so alpha's terms move."""
    params = jmod.init_params(jax.random.PRNGKey(seed))
    if "log_alpha" in params:
        params = dict(params, log_alpha=jax.numpy.asarray(-0.3))
    return params


@pytest.mark.parametrize("which", list(LOSSES))
def test_loss_and_grad_match_jax(which):
    jmod, tmod = _modules(which)
    jloss, tloss = (f() for f in LOSSES[which])
    batch = _batch(which, seed=1)
    jg = _loss_parity(jloss, tloss, jmod, tmod, _start_params(jmod, 1),
                      batch)
    if which == "dqn":  # the Huber loss's both branches are used
        jparams = _start_params(jmod, 1)
        q = np.asarray(jmod.forward_train(jparams, batch["obs"])[0])
        err = q[np.arange(128), batch["actions"]] - batch["td_target"]
        assert (np.abs(err) < 1).any() and (np.abs(err) > 1).any()
    else:  # the temperature takes a gradient
        assert abs(float(jg["log_alpha"])) > 0


@pytest.mark.parametrize("which", list(LOSSES))
def test_update_matches_jax(which):
    jmod, tmod = _modules(which)
    jloss, tloss = (f() for f in LOSSES[which])
    _update_parity(jmod, tmod, jloss, tloss, _batch(which, seed=2))


@pytest.mark.parametrize("which", list(LOSSES))
def test_gang_form_equals_the_whole_batch(which):
    """Every term is a row mean (SAC's alpha term included: one scalar
    leaf times a row mean): 4 equal shards give the whole batch's
    gradient."""
    jmod, tmod = _modules(which)
    jloss, tloss = (f() for f in LOSSES[which])
    _gang_parity(jmod, tmod, jloss, tloss, _batch(which, seed=3))


def test_port_init_draws_the_reference_trees():
    """SAC's modules draw the reference's trees from one generator
    (shapes, dtypes, the scalar `log_alpha`), the same for the same
    seed."""
    for which in ("sac_discrete", "sac_continuous"):
        jmod, tmod = _modules(which)
        want = jax.tree.map(np.asarray,
                            jmod.init_params(jax.random.PRNGKey(0)))
        got = tmod.init_params(torch.Generator().manual_seed(0))
        assert sorted(got) == sorted(want)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert float(got["log_alpha"]) == 0.0
        again = tmod.init_params(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(got), tree_leaves(again)))


# ----------------------------------------------------------------------
# the TD targets against the jitted JAX functions
# ----------------------------------------------------------------------
class _LocalGroup:
    """Stands in for an EnvRunnerGroup at setup: an in-process runner
    answers `env_spec`; weights syncs are kept, not sent."""

    runner_cls = None

    def __init__(self, env, num_runners, num_envs, rollout, seed=0,
                 env_kwargs=None, connector=None, **_kw):
        self._runner = self.runner_cls(env, num_envs, rollout, seed=seed,
                                       env_kwargs=env_kwargs)

    def env_spec(self):
        return self._runner.env_spec()

    def sync_weights(self, weights):
        self.weights = weights

    def connector_state(self):
        return None

    def restore_connector_state(self, state):
        assert state is None

    def stop(self):
        pass


class _JLocal(_LocalGroup):
    runner_cls = jrunner.EnvRunner


class _TLocal(_LocalGroup):
    runner_cls = trunner.EnvRunner


def _built_pair(monkeypatch, which):
    """The JAX package's algorithm and the port's, built over local
    groups, the port started from JAX's learner state."""
    monkeypatch.setattr(jgroup, "EnvRunnerGroup", _JLocal)
    monkeypatch.setattr(tgroup, "EnvRunnerGroup", _TLocal)
    cont = which == "sac_continuous"
    jcfg = (jdqn.DQNConfig() if which == "dqn" else jsac.SACConfig())
    tcfg = (tdqn.DQNConfig() if which == "dqn" else tsac.SACConfig())
    jalgo = (jcfg.environment(JTargetEnv if cont else "CartPole-v1")
             .debugging(seed=0).build())
    talgo = (tcfg.environment(TTargetEnv if cont else "CartPole-v1")
             .learners(device="cpu").debugging(seed=0).build())
    talgo.learner_group.set_state(_port_state(
        jalgo.learner_group.get_state()))
    return jalgo, talgo


def _replay(which, n=64, seed=0):
    rng = np.random.default_rng(seed)
    obs_dim = 2 if which == "sac_continuous" else 4
    out = {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
           "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
           "rewards": rng.normal(size=n).astype(np.float32),
           "terminated": rng.random(n) < 0.3}
    out["actions"] = (np.tanh(rng.normal(size=(n, 2))).astype(np.float32)
                      if which == "sac_continuous"
                      else rng.integers(0, 2, n).astype(np.int32))
    return out


@pytest.mark.parametrize("which", list(LOSSES))
def test_td_targets_match_the_jitted_jax_functions(monkeypatch, which):
    """A target network that differs from the online one (so double-Q's
    argmax and SAC's twin minimum both matter): the port's no-grad
    forward equals the reference's jitted one, and `_td_targets` (with
    SAC's noise from the same generator state) gives the same targets,
    at 1e-5."""
    jalgo, talgo = _built_pair(monkeypatch, which)
    online = jalgo.learner_group.get_weights_numpy()
    rng = np.random.default_rng(5)
    target = jax.tree.map(
        lambda a: (a + rng.normal(size=np.shape(a)) * 0.3).astype(
            np.float32), online)
    jalgo.target_params = target
    talgo.target_params = target
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(
        tree_leaves(talgo._target_dev), jax.tree.leaves(target)))
    replay = _replay(which)
    t_online = talgo._on_learner_device(online)
    next_obs = torch.from_numpy(replay["next_obs"])
    with tdqn.no_grad_f32():
        if which == "dqn":
            got_f = talgo._target_q(talgo._target_dev, next_obs)
            want_f = jalgo._target_q(target, replay["next_obs"])
        elif which == "sac_discrete":
            got_f = talgo._target_terms(talgo._target_dev, t_online,
                                        next_obs)
            want_f = jalgo._target_terms(target, online, replay["next_obs"])
        else:
            noise = np.random.default_rng(9).standard_normal(
                (64, 2)).astype(np.float32)
            got_f = talgo._target_terms(talgo._target_dev, t_online,
                                        next_obs, torch.from_numpy(noise))
            want_f = jalgo._target_terms(target, online, replay["next_obs"],
                                         noise)
    assert not got_f.requires_grad
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
    jalgo._rng = np.random.default_rng(11)
    talgo._rng = np.random.default_rng(11)
    want = jalgo._td_targets(replay, online)
    got = talgo._td_targets(replay, t_online)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    if which == "dqn":  # the double-Q argmax picks differ from the max
        q_t = np.asarray(want_f)
        q_o = np.asarray(jalgo._target_q(online, replay["next_obs"]))
        assert (q_o.argmax(-1) != q_t.argmax(-1)).any()
        assert np.allclose(talgo._td_targets(replay), want, **TOL)


def test_set_state_refreshes_the_device_target(monkeypatch):
    """`set_state` restores the numpy target tree, and with it the copy
    on the learner's device the target forwards read."""
    jalgo, talgo = _built_pair(monkeypatch, "dqn")
    state = talgo.get_state()
    moved = jax.tree.map(lambda a: a + np.float32(1.0),
                         state["target_params"])
    talgo.set_state(dict(state, target_params=moved))
    assert talgo.target_params is moved
    for a, b in zip(tree_leaves(talgo._target_dev), jax.tree.leaves(moved)):
        np.testing.assert_array_equal(a.numpy(), b)


# ----------------------------------------------------------------------
# the reference's cases, on the port
# ----------------------------------------------------------------------
def test_dqn_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import DQNConfig

    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .training(lr=1e-3, learn_batch_size=64, num_updates_per_iter=32,
                  epsilon_decay_iters=15)
        .debugging(seed=0)
        .build()
    )
    try:
        uploads = []
        upload = algo._on_learner_device
        algo._on_learner_device = lambda tree: (uploads.append(1),
                                                upload(tree))[1]
        results = _train(algo, 30)
        early = results[2].get("episode_return_mean", 15.0)
        late = results[-1]["episode_return_mean"]
        assert np.isfinite(results[-1]["td_error_mean"])
        assert late > max(35.0, early + 10.0), (early, late)
        # trees cross to the learner's device once an iteration (the
        # online snapshot) and at each target sync (every 2nd), never
        # an update: 30 + 15
        assert len(uploads) == 30 + 15
    finally:
        algo.stop()


def test_sac_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import SACConfig

    algo = (
        SACConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .learners(device="cpu")
        .training(lr=3e-3)
        .debugging(seed=0)
        .build()
    )
    try:
        results = _train(algo, 20)
        late = results[-1]["episode_return_mean"]
        early = next(r["episode_return_mean"] for r in results
                     if "episode_return_mean" in r)
        assert np.isfinite(results[-1]["critic_loss"])
        assert results[-1]["alpha"] > 0  # temperature stayed positive
        assert late > max(40.0, early + 15.0), (early, late)
    finally:
        algo.stop()


def test_continuous_sac_learns_target_env(cluster):
    from ray_tpu_torch.rllib.algorithms.sac import (
        ContinuousSACModule, SACConfig,
    )

    cfg = (SACConfig()
           .environment(TTargetEnv)
           .env_runners(num_env_runners=1, num_envs_per_env_runner=16,
                        rollout_fragment_length=8)
           .learners(device="cpu")
           .debugging(seed=0))
    cfg.lr = 3e-3
    cfg.num_updates_per_iter = 64
    algo = cfg.build()
    try:
        assert isinstance(algo.module, ContinuousSACModule)

        def run():
            best = -10.0
            for _ in range(30):
                r = algo.train()
                ret = r.get("episode_return_mean")
                if ret is not None and np.isfinite(ret):
                    best = max(best, ret)
                if best > -0.05:
                    break
            return best, r

        best, r = within(180.0, run)
        # optimal return is 0 (a == x); random actions score ~ -1.3
        assert best > -0.15, best
        assert r["alpha"] < 0.9  # temperature auto-tuned downward
    finally:
        algo.stop()


def test_continuous_sac_checkpoint_roundtrip(cluster):
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig

    cfg = (SACConfig()
           .environment(TTargetEnv)
           .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                        rollout_fragment_length=4)
           .learners(device="cpu")
           .debugging(seed=0))
    cfg.num_updates_per_iter = 4
    cfg.learn_batch_size = 32  # one rollout (8 envs x 4) fills it
    algo = cfg.build()
    try:
        within(60.0, algo.train)
        state = algo.get_state()
        algo.set_state(state)  # roundtrips (shapes/dtypes consistent)
        r = within(60.0, algo.train)
        assert np.isfinite(r["critic_loss"])
    finally:
        algo.stop()


@pytest.mark.parametrize("algo", ["DQN", "SAC", "CQL"])
def test_mlp_only_algos_fail_fast_on_pixels(cluster, algo):
    """DQN/SAC replay+module paths are flat-obs-only: image envs must
    fail at setup with a clear message, not an opaque runner crash; CQL
    likewise on a dataset of images."""
    from ray_tpu_torch.rllib import CQLConfig, DQNConfig, SACConfig

    if algo == "CQL":
        rng = np.random.default_rng(0)
        frames = rng.random((16, 10, 10, 1), dtype=np.float32)
        cfg = CQLConfig().offline_data(input_={
            "obs": frames, "next_obs": frames,
            "actions": rng.integers(0, 3, 16).astype(np.int32),
            "rewards": np.zeros(16, np.float32),
            "terminated": np.zeros(16, bool)}).learners(device="cpu")
    else:
        cfg = ({"DQN": DQNConfig, "SAC": SACConfig}[algo]()
               .environment("Catch-v0")
               .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                            rollout_fragment_length=8)
               .learners(device="cpu"))
    with pytest.raises(ValueError, match="flat observations"):
        within(60.0, cfg.build)

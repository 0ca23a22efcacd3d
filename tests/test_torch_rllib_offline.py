"""The port's offline algorithms (`ray_tpu_torch.rllib`: CQL, BC and
MARWIL) against the JAX package's on the CPU, and the reference's cases
for them on the port with the learner on the CPU.

Parity, on the same seeded numpy inputs and params bridged from JAX's
`init_params` (`test_torch_rllib_vtrace.py`'s helpers and limits): the
dataset readers and `discounted_returns` exact (copies); each loss and
its gradient at f32 1e-5 (MARWIL at beta 0 and beta 2); one update
against JAX's learner; CQL's double-DQN targets against the reference's
jitted forward; each loss's gang form against the whole batch.  MARWIL's
advantage normaliser is a root mean square over the minibatch, not a
row mean: its gang case shows the shards' own normalisers moving the
gradient, and the loss's whole-batch statistic giving the whole batch's
update.  The datasets are made in the case from a seed, as the
reference's tests make them.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu_torch.models.bridge import tree_leaves
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.core import rl_module as trm
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


def _cartpole_heuristic_dataset(make_vector_env, n_episodes=60, seed=0):
    """Logged transitions from a decent scripted policy (pole angle +
    angular velocity) with 20% random actions — the behavior-policy
    mixture offline RL must improve on without ever touching the env."""
    env = make_vector_env("CartPole-v1", 1, seed=seed)
    rng = np.random.default_rng(seed)
    data = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "terminated")}
    for _ep in range(n_episodes):
        obs = env.reset()
        for _t in range(500):
            if rng.random() < 0.2:
                a = rng.integers(0, 2)
            else:
                a = 1 if (obs[0][2] + 0.5 * obs[0][3]) > 0 else 0
            nobs, r, term, trunc, _ = env.step(np.array([a], np.int32))
            data["obs"].append(obs[0])
            data["actions"].append(a)
            data["rewards"].append(float(r[0]))
            data["next_obs"].append(nobs[0])
            data["terminated"].append(bool(term[0]))
            obs = nobs
            if bool(term[0] or trunc[0]):
                break
    return {
        "obs": np.asarray(data["obs"], np.float32),
        "actions": np.asarray(data["actions"], np.int32),
        "rewards": np.asarray(data["rewards"], np.float32),
        "next_obs": np.asarray(data["next_obs"], np.float32),
        "terminated": np.asarray(data["terminated"], np.bool_),
    }


def _port_dataset(**kw):
    from ray_tpu_torch.rllib.env.envs import make_vector_env

    return _cartpole_heuristic_dataset(make_vector_env, **kw)


# ----------------------------------------------------------------------
# the numpy copies
# ----------------------------------------------------------------------
def test_heuristic_dataset_is_the_references():
    """The port's CartPole logs the reference's transitions (the env is
    a copy), so the offline cases train on the same data."""
    from ray_tpu.rllib.env.envs import make_vector_env

    got = _port_dataset(n_episodes=5)
    want = _cartpole_heuristic_dataset(make_vector_env, n_episodes=5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_readers_equal_the_originals(tmp_path):
    """`_load_dataset` (a dict and an .npz path), `_coerce_offline` (a
    dict, a list of batches, rows) and `_coerce_offline_marwil` give
    the originals' arrays."""
    rng = np.random.default_rng(0)
    ep = lambda n: {  # noqa: E731
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.2,
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "terminated": rng.random(n) < 0.2}
    one, two = ep(9), ep(7)
    path = str(tmp_path / "d.npz")
    np.savez(path, **one)
    rows = [{"obs": o, "action": a, "rewards": r}
            for o, a, r in zip(two["obs"], two["actions"], two["rewards"])]
    cases = [(tcql._load_dataset, jcql._load_dataset, (one,)),
             (tcql._load_dataset, jcql._load_dataset, (path,)),
             (tbc._coerce_offline, jbc._coerce_offline, (one,)),
             (tbc._coerce_offline, jbc._coerce_offline, ([one, two],)),
             (tbc._coerce_offline, jbc._coerce_offline, (rows,)),
             (tmarwil._coerce_offline_marwil,
              jmarwil._coerce_offline_marwil, ([one, two], 0.9)),
             (tmarwil._coerce_offline_marwil,
              jmarwil._coerce_offline_marwil, (rows, 0.5))]
    for port, orig, args in cases:
        got, want = port(*args), orig(*args)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="missing fields"):
        tcql._load_dataset({"obs": one["obs"]})


def test_marwil_discounted_returns():
    rewards = np.array([1.0, 1.0, 1.0, 2.0], np.float32)
    dones = np.array([False, True, False, True])
    out = tmarwil.discounted_returns(rewards, dones, gamma=0.5)
    # episode 1: [1 + .5*1, 1]; episode 2: [1 + .5*2, 2]
    assert np.allclose(out, [1.5, 1.0, 2.0, 2.0])
    rng = np.random.default_rng(3)
    r = rng.normal(size=300).astype(np.float32)
    d = rng.random(300) < 0.05
    np.testing.assert_array_equal(
        tmarwil.discounted_returns(r, d, 0.99),
        jmarwil.discounted_returns(r, d, 0.99))


def test_marwil_returns_do_not_bleed_across_batches():
    ep1 = {"obs": np.zeros((2, 4), np.float32),
           "actions": np.zeros(2, np.int64),
           "rewards": np.array([1.0, 1.0], np.float32)}
    ep2 = {"obs": np.zeros((2, 4), np.float32),
           "actions": np.zeros(2, np.int64),
           "rewards": np.array([10.0, 10.0], np.float32)}
    out = tmarwil._coerce_offline_marwil([ep1, ep2], gamma=0.5)
    # ep1's returns must not see ep2's rewards (each batch ends an
    # episode): [1+.5, 1] then [10+5, 10]
    assert np.allclose(out["returns"], [1.5, 1.0, 15.0, 10.0])


# ----------------------------------------------------------------------
# the losses, the update, the gang
# ----------------------------------------------------------------------
def _modules(which, hidden=(16, 16)):
    if which == "cql":
        return (jcql.QMLPModule(4, 3, hidden=hidden),
                tcql.QMLPModule(4, 3, hidden=hidden))
    return (jrm.MLPModule(4, 3, hidden=hidden),
            trm.MLPModule(4, 3, hidden=hidden))


LOSSES = {
    "cql": (lambda: jcql.make_cql_loss(1.0), lambda: tcql.make_cql_loss(1.0)),
    "bc": (lambda: jbc.bc_loss, lambda: tbc.bc_loss),
    "marwil_beta0": (lambda: jmarwil.make_marwil_loss(0.0, 1.0, 20.0),
                     lambda: tmarwil.make_marwil_loss(0.0, 1.0, 20.0)),
    "marwil": (lambda: jmarwil.make_marwil_loss(2.0, 1.0, 20.0),
               lambda: tmarwil.make_marwil_loss(2.0, 1.0, 20.0)),
}


def _batch(which, n=128, seed=0):
    """MARWIL's returns are spread so that some weights reach the
    `max_weight` clip and others sit far below it."""
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 3, n).astype(np.int32)}
    if which == "cql":
        batch["td_target"] = (rng.normal(size=n) * 2).astype(np.float32)
    elif which.startswith("marwil"):
        batch["returns"] = (rng.normal(size=n) * 3).astype(np.float32)
    return batch


@pytest.mark.parametrize("which", list(LOSSES))
def test_loss_and_grad_match_jax(which):
    jmod, tmod = _modules(which)
    jloss, tloss = (f() for f in LOSSES[which])
    jparams = jmod.init_params(jax.random.PRNGKey(1))
    batch = _batch(which, seed=1)
    _loss_parity(jloss, tloss, jmod, tmod, jparams, batch)
    if which == "marwil":  # the weight clip bites on some rows only
        _, v = jmod.forward_train(jparams, batch["obs"])
        adv = batch["returns"] - np.asarray(v)
        z = 2.0 * adv / np.sqrt(np.mean(adv ** 2) + 1e-8)
        assert (z > np.log(20.0)).any() and (z < 0).any()


@pytest.mark.parametrize("which", list(LOSSES))
def test_update_matches_jax(which):
    jmod, tmod = _modules(which)
    jloss, tloss = (f() for f in LOSSES[which])
    _update_parity(jmod, tmod, jloss, tloss, _batch(which, seed=2))


@pytest.mark.parametrize("which", list(LOSSES))
def test_gang_form_equals_the_whole_batch(which):
    """CQL's gap (a row mean of logsumexp less the logged Q) and BC's
    NLL are row means; MARWIL's normaliser comes to every shard from
    the whole minibatch (`batch_stats`): 4 equal shards give the whole
    batch's gradient."""
    jmod, tmod = _modules(which)
    jloss, tloss = (f() for f in LOSSES[which])
    _gang_parity(jmod, tmod, jloss, tloss, _batch(which, seed=3))


def test_marwil_gang_without_the_whole_batch_norm_differs():
    """The fault the statistic repairs: shards that normalise by their
    own root mean square give another gradient than the whole batch."""
    from ray_tpu_torch.rllib.core.learner import Learner, make_data_mesh

    _, tmod = _modules("marwil")
    loss = tmarwil.make_marwil_loss(2.0, 1.0, 20.0)

    def own_norm(module, params, batch):  # the loss without batch_stats
        return loss(module, params, batch)

    batch = _batch("marwil", seed=4)
    whole = Learner(tmod, loss, seed=0, device="cpu")
    shards = Learner(tmod, own_norm, seed=0, mesh=make_data_mesh(4, "cpu"))
    fixed = Learner(tmod, loss, seed=0, mesh=make_data_mesh(4, "cpu"))
    for other in (shards, fixed):
        other.set_state(whole.get_state())
    _, wg = whole._grads(batch)
    _, sg = shards._grads(batch)
    _, fg = fixed._grads(batch)
    w = torch.cat([g.ravel() for g in wg])
    s = torch.cat([g.ravel() for g in sg])
    f = torch.cat([g.ravel() for g in fg])
    assert float((s - w).norm() / w.norm()) > 1e-3
    assert float((f - w).norm() / w.norm()) < 1e-6


# ----------------------------------------------------------------------
# CQL's targets against the jitted JAX forward
# ----------------------------------------------------------------------
def test_cql_td_targets_match_the_jitted_jax_forward():
    """CQL needs no runners: both packages build from the same dataset;
    the port, started from JAX's learner state and a target network
    that differs from the online one, gives the reference's double-DQN
    targets at 1e-5."""
    data = _port_dataset(n_episodes=4)
    jalgo = jcql.CQLConfig().offline_data(input_=data).debugging(
        seed=0).build()
    talgo = (tcql.CQLConfig().offline_data(input_=data)
             .learners(device="cpu").debugging(seed=0).build())
    try:
        talgo.learner_group.set_state(_port_state(
            jalgo.learner_group.get_state()))
        online = jalgo.learner_group.get_weights_numpy()
        rng = np.random.default_rng(5)
        target = jax.tree.map(lambda a: (a + rng.normal(
            size=np.shape(a)) * 0.3).astype(np.float32), online)
        jalgo.target_params = target
        talgo.target_params = target
        idx = np.random.default_rng(6).integers(0, len(data["actions"]), 64)
        nxt = data["next_obs"][idx]
        with tdqn.no_grad_f32():
            got_q = talgo._q(talgo._target_dev, torch.from_numpy(nxt))
        np.testing.assert_allclose(got_q.numpy(),
                                   np.asarray(jalgo._q(target, nxt)), **TOL)
        want = jalgo._td_targets(idx, online)
        got = talgo._td_targets(idx, talgo._on_learner_device(online))
        np.testing.assert_allclose(got, want, **TOL)
        # the restored state carries the numpy target, and its device copy
        talgo.set_state(talgo.get_state())
        for a, b in zip(tree_leaves(talgo._target_dev),
                        jax.tree.leaves(target)):
            np.testing.assert_array_equal(a.numpy(), b)
    finally:
        jalgo.stop()
        talgo.stop()


# ----------------------------------------------------------------------
# the reference's cases, on the port
# ----------------------------------------------------------------------
def test_cql_learns_from_offline_data(tmp_path):
    from ray_tpu_torch.rllib import CQLConfig

    dataset = _port_dataset()
    # also exercise the .npz path loader
    path = str(tmp_path / "cartpole_offline.npz")
    np.savez(path, **dataset)

    cfg = CQLConfig()
    cfg.offline_data(input_=path)
    cfg.evaluation(evaluation_env="CartPole-v1", evaluation_episodes=3)
    cfg.training(lr=1e-3, cql_alpha=1.0)
    cfg.learners(device="cpu")
    cfg.debugging(seed=0)
    algo = cfg.build()
    try:
        results = within(180.0, lambda: [algo.train() for _ in range(12)])
        ev = results[-1]["evaluation_return_mean"]
        assert np.isfinite(results[-1]["td_loss"])
        # CQL's conservatism gap must be driven down over training
        assert results[-1]["cql_gap"] < results[0]["cql_gap"]
        # the greedy policy extracted offline performs decently
        assert ev > 60.0, ev
    finally:
        algo.stop()


def test_bc_clones_expert():
    """BC on synthetic expert data reaches high action accuracy (CartPole
    expert rule: push toward the pole's fall)."""
    from ray_tpu_torch.rllib import BCConfig

    rng = np.random.default_rng(0)
    obs = rng.uniform(-0.2, 0.2, size=(4096, 4)).astype(np.float32)
    # expert: action = 1 if pole angle + velocity leans right
    actions = ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)
    algo = (
        BCConfig()
        .environment("CartPole-v1")
        .offline_data(input_={"obs": obs, "actions": actions})
        .learners(device="cpu")
        .training(lr=1e-3, minibatch_size=256, num_updates_per_iter=64)
        .debugging(seed=0)
        .build()
    )
    try:
        last = within(60.0, lambda: [algo.train() for _ in range(5)])[-1]
        assert last["action_accuracy"] > 0.95, last
    finally:
        algo.stop()


def test_bc_checkpoint_keeps_connector_state(cluster):
    """A restored offline run keeps MeanStdObsFilter statistics."""
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig
    from ray_tpu_torch.rllib.connectors import (
        ConnectorPipeline,
        MeanStdObsFilter,
    )

    rng = np.random.default_rng(0)
    dataset = {
        "obs": rng.normal(size=(256, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 256).astype(np.int32),
    }

    def conn():
        return ConnectorPipeline([MeanStdObsFilter()])

    def config(seed):
        cfg = (BCConfig()
               .environment("CartPole-v1")
               .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                            rollout_fragment_length=8,
                            env_to_module_connector=conn)
               .learners(device="cpu")
               .debugging(seed=seed))
        cfg.offline_data(input_=dataset)
        cfg.evaluation_interval = 1
        return cfg

    algo = config(0).build()
    try:
        within(60.0, algo.train)  # evaluation rollout populates stats
        state = algo.get_state()
        assert state.get("connector"), state.keys()
        merged = state["connector"]["0"]
        assert merged.get("count", 0) > 0
        algo2 = config(1).build()
        try:
            algo2.set_state(state)
            restored = algo2.env_runner_group.connector_state()
            assert restored["0"]["count"] == merged["count"]
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_marwil_beta_zero_matches_bc_weighting():
    """beta=0 trains a plain BC policy (weights identically 1)."""
    from ray_tpu_torch.rllib import MARWILConfig

    rng = np.random.default_rng(0)
    obs = rng.uniform(-0.2, 0.2, size=(1024, 4)).astype(np.float32)
    actions = ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)
    rewards = np.ones(1024, np.float32)
    algo = (
        MARWILConfig()
        .environment("CartPole-v1")
        .offline_data(input_={"obs": obs, "actions": actions,
                              "rewards": rewards})
        .learners(device="cpu")
        .training(beta=0.0, lr=1e-3, minibatch_size=256,
                  num_updates_per_iter=32)
        .debugging(seed=0)
        .build()
    )
    try:
        last = within(60.0, lambda: [algo.train() for _ in range(3)])[-1]
        assert last["mean_weight"] == pytest.approx(1.0)
        assert last["action_accuracy"] > 0.9, last
    finally:
        algo.stop()


def test_marwil_upweights_high_advantage_actions():
    """A mixed expert/anti-expert dataset where expert trajectories
    carry higher returns: MARWIL (beta>0) must prefer the expert action
    distribution while BC (beta=0) stays confused at ~50%."""
    from ray_tpu_torch.rllib import MARWILConfig

    rng = np.random.default_rng(1)
    n = 2048
    obs = rng.uniform(-0.2, 0.2, size=(n, 4)).astype(np.float32)
    expert = ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)
    # half the rows log the expert action with reward 1, half log the
    # OPPOSITE action with reward 0 — same states, conflicting labels
    flip = rng.random(n) < 0.5
    actions = np.where(flip, 1 - expert, expert)
    rewards = np.where(flip, 0.0, 1.0).astype(np.float32)
    dones = np.ones(n, bool)  # one-step episodes: return == reward

    def accuracy(beta):
        algo = (
            MARWILConfig()
            .environment("CartPole-v1")
            .offline_data(input_={"obs": obs, "actions": actions,
                                  "rewards": rewards, "dones": dones})
            .learners(device="cpu")
            .training(beta=beta, lr=2e-3, minibatch_size=256,
                      num_updates_per_iter=64)
            .debugging(seed=0)
            .build()
        )
        try:
            within(60.0, lambda: [algo.train() for _ in range(4)])
            # measure agreement with the EXPERT rule, not the logs
            params = algo.learner_group.get_weights_numpy()
            logits, _ = algo.module.forward_numpy(params, obs)
            pred = logits.argmax(axis=-1)
            return float((pred == expert).mean())
        finally:
            algo.stop()

    acc_marwil = accuracy(beta=2.0)
    assert acc_marwil > 0.8, f"MARWIL failed to exploit returns: {acc_marwil}"

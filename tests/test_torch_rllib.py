"""The port's rllib PPO path (`ray_tpu_torch.rllib`) against the JAX
package's on the CPU, on the same seeded numpy inputs: the modules'
forwards, the PPO loss and its gradient, one learner update (clipped and
unclipped), the optimizer alone, a 3-update trajectory, the learner
gang, the state crossing, the weight bridge's list trees and Adam
state, and one PPO iteration end to end.

Inits cannot match (`jax.random` against `torch.Generator`), so every
parity case starts the port from JAX's parameters and optimizer state
through the bridge.  Tolerance: f32 at rtol / atol 1e-5 unless a case
says otherwise.  Adam divides a gradient by its own running magnitude,
so where a gradient is at f32 rounding level (nonzero, below 1e-6 of
its leaf's largest) the sign of its step is noise: those elements (at most `NOISY_SHARE` of a
learner's) are held to one step's worth (lr), and the optimizer is held
on every element on its own (`test_adamw_alone_matches_optax`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu as jrt
import ray_tpu_torch as trt
from ray_tpu.rllib import PPOConfig as JPPOConfig
from ray_tpu.rllib.algorithms.ppo import make_ppo_loss as jmake_loss
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.core.learner import Learner as JLearner
from ray_tpu.rllib.core.learner import LearnerGroup as JLearnerGroup
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models.gpt2 import AdamW
from ray_tpu_torch.rllib import PPOConfig as TPPOConfig
from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss as tmake_loss
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.core.learner import Learner as TLearner
from ray_tpu_torch.rllib.core.learner import LearnerGroup as TLearnerGroup
from test_torch_waits import within

TOL = dict(rtol=1e-5, atol=1e-5)
NOISY_SHARE = 0.005
LR = 1e-2

jloss, tloss = jmake_loss(), tmake_loss()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_close(got, want, err="", **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want), err
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=err, **(tol or TOL))


def _mlp(hidden=(16, 16)):
    return jrm.MLPModule(4, 2, hidden=hidden), trm.MLPModule(4, 2,
                                                             hidden=hidden)


def _cnn(shape, filters, hidden=(32,), actions=3):
    return (jrm.CNNModule(shape, actions, conv_filters=filters,
                          hidden=hidden),
            trm.CNNModule(shape, actions, conv_filters=filters,
                          hidden=hidden))


def _batch(n, obs_shape, actions=2, seed=0):
    """A minibatch whose old log-probabilities spread the ratio across
    PPO's clip range, so both branches of the surrogate and of the value
    clip carry gradient."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, *obs_shape)).astype(np.float32),
        "actions": rng.integers(0, actions, n).astype(np.int32),
        "logp": np.log(rng.uniform(0.5, 1.5, n) / actions
                       ).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": (rng.normal(size=n) * 8).astype(np.float32),
    }


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_params(jparams):
    return bridge.tree_map(lambda t: t.requires_grad_(True),
                           bridge.params_from_numpy(_np(jparams), "cpu"))


def _port_state(jstate):
    """A JAX learner's `get_state()` in the port's layout: the params as
    they are, optax's Adam state (`opt_state[1][0]` of
    `chain(clip | identity, adam)`) as count, mu and nu."""
    adam = jstate["opt_state"][1][0]
    return {"params": jstate["params"],
            "opt_state": {"count": adam.count, "mu": adam.mu,
                          "nu": adam.nu}}


def _learners(jmod, tmod, grad_clip=0.5, seed=0, **kw):
    """A JAX learner and the port's, started from the JAX one's state."""
    jl = JLearner(jmod, jloss, lr=LR, grad_clip=grad_clip, seed=seed)
    tl = TLearner(tmod, tloss, lr=LR, grad_clip=grad_clip, seed=seed,
                  device="cpu", **kw)
    tl.set_state(_port_state(jl.get_state()))
    return jl, tl


def _jax_grads(jmod, jparams, batch):
    """JAX's loss, metrics and gradient, jitted (one compile, where
    eager dispatch compiles every op on its own)."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jmod, p, b), has_aux=True))(jparams, batch)
    return float(loss), metrics, grads


def _noisy(jgrads):
    """Elements whose gradient is at rounding level for its leaf
    (nonzero, below 1e-6 of the leaf's largest): the two sides' sums
    differ by ~1e-7 of that largest, so the sign can differ there."""
    noisy = []
    for g in jax.tree.leaves(jgrads):
        g = np.abs(np.asarray(g))
        noisy.append((g < 1e-6 * g.max()) & (g != 0))
    share = sum(int(n.sum()) for n in noisy) / sum(n.size for n in noisy)
    assert share < NOISY_SHARE, share
    return noisy


def _params_close(got, want, noisy):
    """Updated params: at 1e-5 where the gradient is above rounding
    level, within one step (lr) where it is not."""
    for g, w, n in zip(jax.tree.leaves(got), jax.tree.leaves(_np(want)),
                       noisy):
        np.testing.assert_allclose(g[~n], w[~n], **TOL)
        np.testing.assert_allclose(g[n], w[n], rtol=0, atol=LR)


# ----------------------------------------------------------------------
# the weight bridge: list trees and Adam state
# ----------------------------------------------------------------------
def test_bridge_walks_lists_and_tuples_in_jax_order():
    rng = np.random.default_rng(0)
    tree = {"pi": [{"w": rng.normal(size=(3, 2)).astype(np.float32),
                    "b": np.zeros(2, np.float32)},
                   {"w": rng.normal(size=(2, 1)).astype(np.float32),
                    "b": np.ones(1, np.float32)}],
            "aux": (np.arange(3, dtype=np.int32),
                    rng.normal(size=4).astype(np.float32))}
    port = bridge.params_from_numpy(tree, "cpu")
    assert isinstance(port["pi"], list) and isinstance(port["aux"], tuple)
    assert port["aux"][0].dtype == torch.int32
    back = bridge.params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the port's leaf order is jax.tree.leaves', and unflatten inverts it
    got = [t.numpy() for t in bridge.tree_leaves(port)]
    for a, b in zip(got, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    again = bridge.tree_unflatten(tree, got)
    assert jax.tree.structure(again) == jax.tree.structure(tree)


def test_bridge_carries_optax_adam_state_both_ways():
    jmod, tmod = _mlp()
    jl = JLearner(jmod, jloss, lr=LR, seed=3)
    for s in range(2):
        jl.update_minibatch(_batch(32, (4,), seed=s))
    adam = jl.get_state()["opt_state"][1][0]
    state = bridge.adam_state_from_numpy(adam.count, adam.mu, adam.nu,
                                         "cpu")
    assert state["count"] == 2
    for k in ("mu", "nu"):
        for t, w in zip(state[k], jax.tree.leaves(getattr(adam, k))):
            np.testing.assert_array_equal(t.numpy(), w)
    back = bridge.adam_state_to_numpy(state, jl.get_state()["params"])
    assert back["count"] == 2 and back["count"].dtype == np.int32
    for k in ("mu", "nu"):
        assert (jax.tree.structure(back[k])
                == jax.tree.structure(getattr(adam, k)))
        for a, b in zip(jax.tree.leaves(back[k]),
                        jax.tree.leaves(getattr(adam, k))):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------
def test_mlp_forward_matches_jax():
    jmod, tmod = _mlp()
    jparams = jmod.init_params(jax.random.PRNGKey(0))
    obs = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    jl, jv = jax.jit(jmod.forward_train)(jparams, obs)
    tl, tv = tmod.forward_train(_port_params(jparams), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)
    # the runners' numpy forward reads the same tree
    nl, nv = tmod.forward_numpy(trm.params_to_numpy(_port_params(jparams)),
                                obs)
    np.testing.assert_allclose(nl, np.asarray(jl), **TOL)
    np.testing.assert_allclose(nv, np.asarray(jv), **TOL)


# spatial shapes that exercise XLA's SAME padding: the default stack at
# Atari's stacked frame (84 with k 4 s 2 pads (1, 2), then 42 and 21);
# 10 x 5 with k 3 s 2 pads 10 by (0, 1) and 5 by (1, 1); an odd 7 x 7
CNN_CASES = {
    "10x5_k3s2": ((10, 5, 1), ((16, 3, 2),), (32,)),
    "7x7_odd": ((7, 7, 3), ((8, 3, 2), (16, 2, 1)), (16,)),
    "atari_default": ((84, 84, 4), ((16, 4, 2), (32, 4, 2), (64, 3, 2)),
                      (256,)),
}


@pytest.mark.parametrize("case", list(CNN_CASES))
def test_cnn_forward_matches_jax(case):
    shape, filters, hidden = CNN_CASES[case]
    jmod, tmod = _cnn(shape, filters, hidden)
    jparams = jmod.init_params(jax.random.PRNGKey(1))
    obs = np.random.default_rng(1).random((3, *shape), dtype=np.float32)
    jl, jv = jax.jit(jmod.forward_train)(jparams, obs)
    tl, tv = tmod.forward_train(_port_params(jparams), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("n,k,s", [(84, 4, 2), (10, 3, 2), (5, 3, 2),
                                   (7, 2, 1), (21, 3, 2), (11, 4, 3)])
def test_same_pad_matches_xla(n, k, s):
    """`same_pad` gives XLA's (lo, hi) SAME padding: one conv through
    `lax.conv_general_dilated(padding="SAME")` equals `conv2d` on the
    input padded by it, and the output size is `conv_out_dims`'."""
    lo, hi = trm.same_pad(n, k, s)
    rng = np.random.default_rng(n * k + s)
    x = rng.normal(size=(1, n, n, 2)).astype(np.float32)
    w = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                (lo, hi, lo, hi)),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    assert want.shape[1:3] == trm.conv_out_dims(n, n, ((3, k, s),))[-1]


def test_port_init_draws_the_reference_tree():
    """The port's own init: the JAX package's tree, shapes and dtypes
    (values from another generator), the same for the same seed."""
    for jmod, tmod in (_mlp(), _cnn(*CNN_CASES["7x7_odd"])):
        want = _np(jmod.init_params(jax.random.PRNGKey(0)))
        got = tmod.init_params(torch.Generator().manual_seed(0))
        assert jax.tree.structure(trm.params_to_numpy(got)) == \
            jax.tree.structure(want)
        for a, b in zip(bridge.tree_leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        again = tmod.init_params(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(
            bridge.tree_leaves(got), bridge.tree_leaves(again)))


# ----------------------------------------------------------------------
# the loss, the update, the optimizer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_ppo_loss_and_grad_match_jax(which):
    if which == "mlp":
        (jmod, tmod), shape, acts = _mlp(), (4,), 2
    else:
        (jmod, tmod), shape, acts = _cnn(*CNN_CASES["10x5_k3s2"]), (10, 5,
                                                                    1), 3
    jparams = jmod.init_params(jax.random.PRNGKey(2))
    batch = _batch(64, shape, acts, seed=2)
    jl, jm, jg = _jax_grads(jmod, jparams, batch)
    tparams = _port_params(jparams)
    tl, tm = tloss(tmod, tparams, _tensors(batch))
    tg = torch.autograd.grad(tl, bridge.tree_leaves(tparams))
    np.testing.assert_allclose(float(tl.detach()), jl, **TOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   err_msg=k, **TOL)
    for g, w in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the ratio clip is engaged on some rows, as the batch intends
    ratio = np.exp(np.asarray(jax.nn.log_softmax(
        jmod.forward_train(jparams, batch["obs"])[0]))[
        np.arange(64), batch["actions"]] - batch["logp"])
    assert ((ratio < 0.8) | (ratio > 1.2)).any()


@pytest.mark.parametrize("grad_clip", [0.5, None], ids=["clipped",
                                                        "unclipped"])
def test_learner_update_matches_jax(grad_clip):
    jmod, tmod = _mlp()
    jl, tl = _learners(jmod, tmod, grad_clip)
    batch = _batch(128, (4,), seed=4)
    _, _, jg = _jax_grads(jmod, jl.params, batch)
    norm = float(optax.global_norm(jg))
    assert norm > 0.5  # the clip acts in the clipped case
    noisy = _noisy(jg)
    jm = jl.update_minibatch(batch)
    tm = tl.update_minibatch(batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
    _params_close(tl.get_weights_numpy(), jl.params, noisy)
    assert tl.opt_state["count"] == 1


def test_adamw_alone_matches_optax():
    """`gpt2.AdamW` as the learner configures it, fed JAX's gradient and
    optax's state, gives optax's update and moments on every element
    (`chain(clip_by_global_norm(0.5), adam(lr))`, two steps)."""
    jmod, _ = _mlp()
    jparams = jmod.init_params(jax.random.PRNGKey(5))
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(LR))
    jstate = opt.init(jparams)
    topt = AdamW(lambda _c: LR, max_norm=0.5, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0)
    for step in range(2):
        _, _, jg = _jax_grads(jmod, jparams, _batch(64, (4,), seed=step))
        adam = jstate[1][0]
        tparams = bridge.params_from_numpy(_np(jparams), "cpu")
        tstate = bridge.adam_state_from_numpy(adam.count, adam.mu, adam.nu,
                                              "cpu")
        tstate, norm = topt.update(
            [torch.from_numpy(np.array(g)) for g in jax.tree.leaves(jg)],
            tstate, tparams)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(jg)), **TOL)
        upd, jstate = opt.update(jg, jstate, jparams)
        new = optax.apply_updates(jparams, upd)
        for g, w, p0 in zip(bridge.tree_leaves(tparams),
                            jax.tree.leaves(_np(new)),
                            jax.tree.leaves(_np(jparams))):
            np.testing.assert_allclose(g.numpy() - p0, w - p0, rtol=1e-5,
                                       atol=1e-5 * LR)
        for k in ("mu", "nu"):
            for g, w in zip(tstate[k],
                            jax.tree.leaves(getattr(jstate[1][0], k))):
                w = np.asarray(w)
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max())
        assert tstate["count"] == int(jstate[1][0].count)
        jparams = new


@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_three_updates_each_from_jax_state(which):
    """3 updates, the port stepped from the JAX learner's state before
    each (a free trajectory inherits Adam's sign noise on rounding-level
    gradients from update 1 on)."""
    if which == "mlp":
        (jmod, tmod), shape, acts = _mlp(), (4,), 2
    else:
        (jmod, tmod), shape, acts = _cnn(*CNN_CASES["7x7_odd"]), (7, 7, 3), 3
    jl, tl = _learners(jmod, tmod)
    losses = []
    for step in range(3):
        batch = _batch(96, shape, acts, seed=10 + step)
        tl.set_state(_port_state(jl.get_state()))
        _, _, jg = _jax_grads(jmod, jl.params, batch)
        noisy = _noisy(jg)
        jm = jl.update_minibatch(batch)
        tm = tl.update_minibatch(batch)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
        _params_close(tl.get_weights_numpy(), jl.params, noisy)
        got = tl.get_state()["opt_state"]
        adam = jl.get_state()["opt_state"][1][0]
        assert int(got["count"]) == int(adam.count) == step + 1
        for k in ("mu", "nu"):
            for g, w in zip(jax.tree.leaves(got[k]),
                            jax.tree.leaves(getattr(adam, k))):
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=1e-5 * max(np.abs(w).max(), 1e-30))
        losses.append(tm["total_loss"])
    assert np.isfinite(losses).all()


def test_learner_state_crosses_from_jax():
    """A JAX learner's `get_state()` after two updates, restored into a
    port learner, gives the same next update; the port's own state
    round-trips bit for bit."""
    jmod, tmod = _mlp()
    jl = JLearner(jmod, jloss, lr=LR, seed=7)
    for s in range(2):
        jl.update_minibatch(_batch(64, (4,), seed=20 + s))
    tl = TLearner(tmod, tloss, lr=LR, seed=99, device="cpu")
    tl.set_state(_port_state(jl.get_state()))
    _tree_close(tl.get_weights_numpy(), _np(jl.params), rtol=0, atol=0)
    batch = _batch(64, (4,), seed=22)
    _, _, jg = _jax_grads(jmod, jl.params, batch)
    noisy = _noisy(jg)
    saved = tl.get_state()
    jm, tm = jl.update_minibatch(batch), tl.update_minibatch(batch)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
    _params_close(tl.get_weights_numpy(), jl.params, noisy)
    after = tl.get_weights_numpy()
    # the saved state is a copy: restoring it and updating again repeats
    tl.set_state(saved)
    tl.update_minibatch(batch)
    _tree_close(tl.get_weights_numpy(), after, rtol=0, atol=0)


# ----------------------------------------------------------------------
# the learner gang
# ----------------------------------------------------------------------
def test_gang_of_four_matches_local_and_the_jax_mesh():
    """A gang of 4 (equal row shards, gradients averaged before one
    step) against the port's local learner and against the JAX
    package's 4-device mesh learner, all from JAX's start."""
    jmod, tmod = _mlp()
    jlocal = JLearnerGroup(jmod, jloss, lr=LR, seed=0)
    jgang = JLearnerGroup(jmod, jloss, lr=LR, seed=0, gang_devices=4)
    start = _port_state(jlocal.get_state())
    tlocal = TLearnerGroup(tmod, tloss, lr=LR, seed=0, device="cpu")
    tgang = TLearnerGroup(tmod, tloss, lr=LR, seed=0, gang_devices=4,
                          device="cpu")
    assert tgang.num_gang_devices == jgang.num_gang_devices == 4
    assert tlocal.num_gang_devices == 1
    tlocal.set_state(start)
    tgang.set_state(start)
    batch = _batch(128, (4,), seed=30)
    _, _, jg = _jax_grads(jmod, jlocal._local.params, batch)
    noisy = _noisy(jg)
    jm = jgang.update_minibatch(batch)
    m_local = tlocal.update_minibatch(batch)
    m_gang = tgang.update_minibatch(batch)
    for k in jm:
        np.testing.assert_allclose(m_gang[k], m_local[k], err_msg=k, **TOL)
        np.testing.assert_allclose(m_gang[k], jm[k], err_msg=k, **TOL)
    _params_close(tgang.get_weights_numpy(), tlocal.get_weights_numpy(),
                  noisy)
    _params_close(tgang.get_weights_numpy(), jgang.get_weights_numpy(),
                  noisy)


def test_gang_keeps_the_references_errors():
    jmod, tmod = _mlp()
    with pytest.raises(ValueError, match="alternative scaling"):
        TLearnerGroup(tmod, tloss, num_learners=2, gang_devices=2,
                      device="cpu")
    with pytest.raises(ValueError, match="alternative scaling"):
        JLearnerGroup(jmod, jloss, num_learners=2, gang_devices=2)
    batch = _batch(30, (4,), seed=31)  # 30 rows over 4 devices
    with pytest.raises(ValueError):
        JLearnerGroup(jmod, jloss, gang_devices=4).update_minibatch(batch)
    with pytest.raises(ValueError, match="does not divide"):
        TLearnerGroup(tmod, tloss, gang_devices=4,
                      device="cpu").update_minibatch(batch)


# ----------------------------------------------------------------------
# one PPO iteration end to end
# ----------------------------------------------------------------------
def _ppo(cls, **learners):
    return (cls().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .learners(**learners)
            .training(lr=LR, minibatch_size=64, num_epochs=2)
            .debugging(seed=0))


def test_one_ppo_iteration_matches_jax():
    """One sync `PPO.train()` on a port cluster against the JAX
    package's PPO from the bridged start.  The runners are numpy copies
    seeded alike, so equal weights draw equal rollouts: equal
    `num_env_steps_sampled`, the metrics and the weights at 1e-5 (the
    noisy mask for the weights)."""
    jrt.init(num_workers=2, num_cpus=4, ignore_reinit_error=True)
    try:
        jalgo = _ppo(JPPOConfig).build()
        try:
            start = jalgo.learner_group.get_state()
            jres = within(120.0, jalgo.train)
            jweights = jalgo.learner_group.get_weights_numpy()
        finally:
            jalgo.stop()
    finally:
        jrt.shutdown()
    trt.init(num_workers=2, num_cpus=4, ignore_reinit_error=True)
    try:
        talgo = _ppo(TPPOConfig, device="cpu").build()
        try:
            talgo.learner_group.set_state(_port_state(start))
            talgo.env_runner_group.sync_weights(
                talgo.learner_group.get_weights_numpy())
            tres = within(120.0, talgo.train)
            tweights = talgo.learner_group.get_weights_numpy()
        finally:
            talgo.stop()
    finally:
        trt.shutdown()
    assert tres["num_env_steps_sampled"] == jres["num_env_steps_sampled"]
    assert tres["num_learner_updates"] == jres["num_learner_updates"] == 8
    for k in ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl",
              "episode_return_mean"):
        np.testing.assert_allclose(tres[k], jres[k], err_msg=k, **TOL)
    _tree_close(tweights, jweights)

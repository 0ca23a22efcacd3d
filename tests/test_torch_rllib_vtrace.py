"""The port's v-trace algorithms (`ray_tpu_torch.rllib`: APPO and
IMPALA) against the JAX package's on the CPU, and the reference's cases
for them on the port with the learner on the CPU.

Parity, on the same seeded numpy inputs and params bridged from JAX's
`init_params` (inits cannot match): `compute_vtrace` and `_logsumexp`
exact (they are copies); each loss, its metrics and its gradient at f32
rtol / atol 1e-5, the gradient also by the relative norm of the
difference (1e-5); one `update_minibatch` against JAX's learner from
JAX's state (metrics 1e-5, params rtol 1e-5 / atol 1e-6, with
rounding-level gradients held to one step, `lr`, as
`test_torch_rllib.py` does); each loss's gang form (4 equal row shards)
against the whole batch at 1e-6.

The shared parity helpers here serve the replay and offline files too.
Every wait has a limit (`within`).
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.core.learner import Learner as JLearner
from ray_tpu_torch.models.bridge import tree_leaves
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.core.learner import Learner as TLearner
from ray_tpu_torch.rllib.core.learner import make_data_mesh
from test_torch_rllib import _noisy, _np, _port_params, _port_state, _tensors
from test_torch_waits import within

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
GANG_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-5
LR = 1e-2


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


# ----------------------------------------------------------------------
# parity helpers (also imported by the replay and offline files)
# ----------------------------------------------------------------------
def _grad_rel(got, want) -> float:
    g = np.concatenate([np.asarray(x, np.float64).ravel() for x in got])
    w = np.concatenate([np.asarray(x, np.float64).ravel() for x in want])
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _loss_parity(jloss, tloss, jmod, tmod, jparams, batch):
    """The JAX loss (jitted value and grad) and the port's on the same
    bridged params and batch: loss, metrics and every gradient leaf at
    1e-5, the gradient's relative norm under 1e-5.  Returns the JAX
    gradient."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jmod, p, b), has_aux=True))(jparams, batch)
    tparams = _port_params(jparams)
    tl, tm = tloss(tmod, tparams, _tensors(batch))
    tg = torch.autograd.grad(tl, tree_leaves(tparams), allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   err_msg=k, **TOL)
    want = [np.asarray(w) for w in jax.tree.leaves(jg)]
    assert len(tg) == len(want)
    for g, w in zip(tg, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    rel = _grad_rel([g.numpy() for g in tg], want)
    assert rel <= GRAD_REL, rel
    return jg


def _update_parity(jmod, tmod, jloss, tloss, batch, grad_clip=0.5,
                   seed=0):
    """One `update_minibatch` of JAX's learner and of the port's started
    from JAX's state: metrics at 1e-5, params at rtol 1e-5 / atol 1e-6
    (rounding-level gradients, `_noisy`, within one step).  Returns the
    two learners."""
    jl = JLearner(jmod, jloss, lr=LR, grad_clip=grad_clip, seed=seed)
    tl = TLearner(tmod, tloss, lr=LR, grad_clip=grad_clip, seed=seed,
                  device="cpu")
    tl.set_state(_port_state(jl.get_state()))
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jmod, p, b), has_aux=True))(jl.params, batch)
    noisy = _noisy(jg)
    jm = jl.update_minibatch(batch)
    tm = tl.update_minibatch(batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
    for g, w, n in zip(jax.tree.leaves(tl.get_weights_numpy()),
                       jax.tree.leaves(_np(jl.params)), noisy):
        np.testing.assert_allclose(g[~n], w[~n], **PARAM_TOL)
        np.testing.assert_allclose(g[n], w[n], rtol=0, atol=LR)
    assert tl.opt_state["count"] == 1
    return jl, tl


def _gang_parity(jmod, tmod, jloss, tloss, batch, devices=4, seed=0):
    """The port's gang (`devices` equal row shards, gradients averaged)
    against its whole-batch learner from the same state: metrics and
    gradients at 1e-6, then the updated params."""
    jl = JLearner(jmod, jloss, lr=LR, seed=seed)
    state = _port_state(jl.get_state())
    whole = TLearner(tmod, tloss, lr=LR, seed=seed, device="cpu")
    gang = TLearner(tmod, tloss, lr=LR, seed=seed,
                    mesh=make_data_mesh(devices, "cpu"))
    whole.set_state(state)
    gang.set_state(state)
    wm, wg = whole._grads(batch)
    gm, gg = gang._grads(batch)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), err_msg=k,
                                   **GANG_TOL)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GANG_TOL)
    whole.update_minibatch(batch)
    gang.update_minibatch(batch)
    for g, w in zip(jax.tree.leaves(gang.get_weights_numpy()),
                    jax.tree.leaves(whole.get_weights_numpy())):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    return wg, gg


# ----------------------------------------------------------------------
# v-trace: the numpy copies
# ----------------------------------------------------------------------
def _rollout(T=16, B=5, seed=0, off_policy=True):
    rng = np.random.default_rng(seed)
    terminated = rng.random((T, B)) < 0.1
    truncated = (rng.random((T, B)) < 0.1) & ~terminated
    behavior = rng.normal(size=(T, B)).astype(np.float32) - 1.0
    target = (behavior + rng.normal(size=(T, B)).astype(np.float32) * 0.7
              if off_policy else behavior)
    return dict(
        behavior_logp=behavior, target_logp=target.astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        final_value=rng.normal(size=B).astype(np.float32),
        terminated=terminated, truncated=truncated,
        bootstrap_values=rng.normal(size=(T, B)).astype(np.float32),
    )


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.5, 2.0)],
                         ids=["default_clip", "rho_0.5_c_2"])
def test_compute_vtrace_equals_the_original(clip):
    """Off-policy rollouts with terminations and truncations: the port's
    `compute_vtrace` returns the original's arrays exactly."""
    for seed in range(3):
        inp = _rollout(seed=seed)
        got = tappo.compute_vtrace(**inp, gamma=0.97, clip_rho=clip[0],
                                   clip_c=clip[1])
        want = jappo.compute_vtrace(**inp, gamma=0.97, clip_rho=clip[0],
                                    clip_c=clip[1])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    # the rho clip bites on some steps, or the case proves little
    ratio = np.exp(inp["target_logp"] - inp["behavior_logp"])
    assert (ratio > 1.0).any() and (ratio < 1.0).any()


def test_logsumexp_equals_the_original():
    x = np.random.default_rng(0).normal(size=(7, 3, 5)).astype(np.float32)
    x[0, 0] = 80.0  # large logits: the max shift must hold
    np.testing.assert_array_equal(tappo._logsumexp(x), jappo._logsumexp(x))
    # IMPALA reads both from APPO's module, as the reference does
    assert timpala.compute_vtrace is tappo.compute_vtrace
    assert timpala._logsumexp is tappo._logsumexp


def test_vtrace_on_policy_reduces_to_td():
    """When behavior == target policy (all IS ratios 1), V-trace
    targets equal the plain TD(1)-corrected values recursion — the
    standard sanity check on the Espeholt et al. math."""
    rng = np.random.default_rng(0)
    T, B = 12, 3
    logp = rng.normal(size=(T, B)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    final_value = rng.normal(size=B).astype(np.float32)
    never = np.zeros((T, B), bool)
    boot = np.zeros((T, B), np.float32)
    gamma = 0.97
    adv, vs = tappo.compute_vtrace(
        logp, logp, rewards, values, final_value, never, never, boot, gamma
    )
    # rho=c=1: vs_t = r_t + gamma * vs_{t+1}; vs_T = final_value
    expect = np.zeros((T, B), np.float32)
    nxt = final_value
    for t in range(T - 1, -1, -1):
        expect[t] = rewards[t] + gamma * nxt
        nxt = expect[t]
    np.testing.assert_allclose(vs, expect, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# the losses, the update, the gang
# ----------------------------------------------------------------------
def _modules(hidden=(16, 16)):
    return (jrm.MLPModule(4, 3, hidden=hidden),
            trm.MLPModule(4, 3, hidden=hidden))


def _vtrace_batch(n=128, seed=0, actions=3):
    """A minibatch whose behavior log-probs spread the importance ratio
    across APPO's clip range (both surrogate branches carry gradient)."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, actions, n).astype(np.int32),
        "behavior_logp": np.log(rng.uniform(0.4, 1.6, n) / actions
                                ).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": (rng.normal(size=n) * 4).astype(np.float32),
    }


LOSSES = {
    "appo": (lambda: jappo.make_appo_loss(0.3, 0.5, 0.01),
             lambda: tappo.make_appo_loss(0.3, 0.5, 0.01)),
    "impala": (lambda: jimpala.make_impala_loss(0.5, 0.01),
               lambda: timpala.make_impala_loss(0.5, 0.01)),
}


def _batch_for(algo, n=128, seed=0):
    batch = _vtrace_batch(n, seed)
    if algo == "impala":
        del batch["behavior_logp"]
    return batch


@pytest.mark.parametrize("algo", list(LOSSES))
def test_loss_and_grad_match_jax(algo):
    jmod, tmod = _modules()
    jloss, tloss = (f() for f in LOSSES[algo])
    jparams = jmod.init_params(jax.random.PRNGKey(1))
    batch = _batch_for(algo, seed=1)
    _loss_parity(jloss, tloss, jmod, tmod, jparams, batch)
    if algo == "appo":  # the ratio clip is engaged on some rows
        logits = np.asarray(jmod.forward_train(jparams, batch["obs"])[0])
        logp = logits - jappo._logsumexp(logits)
        ratio = np.exp(logp[np.arange(128), batch["actions"]]
                       - batch["behavior_logp"])
        assert ((ratio < 0.7) | (ratio > 1.3)).any()


@pytest.mark.parametrize("algo", list(LOSSES))
def test_update_matches_jax(algo):
    jmod, tmod = _modules()
    jloss, tloss = (f() for f in LOSSES[algo])
    _update_parity(jmod, tmod, jloss, tloss, _batch_for(algo, seed=2))


@pytest.mark.parametrize("algo", list(LOSSES))
def test_gang_form_equals_the_whole_batch(algo):
    """Every term of both losses is a row mean: 4 equal shards'
    averaged gradient is the whole batch's."""
    jmod, tmod = _modules()
    jloss, tloss = (f() for f in LOSSES[algo])
    _gang_parity(jmod, tmod, jloss, tloss, _batch_for(algo, seed=3))


# ----------------------------------------------------------------------
# the reference's cases, on the port
# ----------------------------------------------------------------------
def test_appo_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import APPOConfig

    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .learners(device="cpu")
        .training(lr=5e-4, minibatch_size=256)
        .debugging(seed=0)
        .build()
    )
    try:
        results = within(120.0, lambda: [algo.train() for _ in range(25)])
        early = results[0]["episode_return_mean"]
        late = results[-1]["episode_return_mean"]
        assert np.isfinite(results[-1]["total_loss"])
        assert late > max(40.0, early + 15.0), (early, late)
    finally:
        algo.stop()


def test_impala_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .learners(device="cpu")
        .training(lr=5e-4, minibatch_size=256)
        .debugging(seed=0)
        .build()
    )
    try:
        results = within(120.0, lambda: [algo.train() for _ in range(25)])
        late = results[-1]["episode_return_mean"]
        early = next(
            r["episode_return_mean"] for r in results
            if "episode_return_mean" in r
        )
        assert np.isfinite(results[-1]["total_loss"])
        # async pipeline delivered batches without blocking on all
        # runners each step
        assert any(r.get("num_async_batches", 0) >= 1 for r in results)
        assert late > max(40.0, early + 15.0), (early, late)
        # exact accounting over the batches actually consumed
        led = algo.env_runner_group.ledger.snapshot()
        assert led["unique"] == led["batches"]
        assert led["env_steps"] == sum(r["num_env_steps_sampled"]
                                       for r in results)
    finally:
        algo.stop()


def test_impala_async_pipeline_tolerates_runner_death(cluster):
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .training(minibatch_size=128)
        .build()
    )
    try:
        within(60.0, algo.train)
        # kill one runner mid-pipeline; training must continue
        rt.kill(algo.env_runner_group._runners[0])
        r = within(120.0, lambda: [algo.train() for _ in range(3)])[-1]
        assert r["num_env_steps_sampled"] > 0
    finally:
        algo.stop()


def test_appo_checkpoint_restores_learner_and_runners(cluster):
    """`get_state` / `set_state` carry the learner (optax's layout) and
    push the restored weights to the runners, bit for bit."""
    from ray_tpu_torch.rllib import APPOConfig

    cfg = (APPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
           .learners(device="cpu")
           .training(minibatch_size=64)
           .debugging(seed=0))
    algo, algo2 = cfg.build(), cfg.build()
    try:
        within(60.0, algo.train)
        state = algo.get_state()
        algo2.set_state(state)
        assert algo2.iteration == algo.iteration == 1
        for a, b in zip(
                tree_leaves(algo2.learner_group.get_weights_numpy()),
                tree_leaves(algo.learner_group.get_weights_numpy())):
            np.testing.assert_array_equal(a, b)
        sent = rt.get(algo2.env_runner_group._weights_refs[-1]["ref"],
                      timeout=60)
        for a, b in zip(tree_leaves(sent),
                        tree_leaves(algo.learner_group.get_weights_numpy())):
            np.testing.assert_array_equal(a, b)
        assert int(algo2.learner_group.get_state()["opt_state"]["count"]) \
            == int(state["learner"]["opt_state"]["count"]) > 0
    finally:
        algo.stop()
        algo2.stop()

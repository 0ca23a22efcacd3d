"""Card tests of the rest of rllib's learners (torch only: they run
where the card is, without JAX).  Marked `cuda`; each skips here, where
there is no card.

One update of each algorithm's loss on the card against the plain CPU
learner from the same params, optimizer state and minibatch: APPO and
IMPALA (v-trace targets in the batch), DQN, discrete and continuous SAC
(the same reparameterisation draw, `batch["noise"]`), CQL, BC and
MARWIL, each at CartPole's default widths and its algorithm's default
minibatch; a multi-agent PPO module (the coordination game's 2 inputs,
the config's coefficients, lr 3e-3) on a minibatch its runner sampled.
DQN's, SAC's and CQL's no-grad target forwards on the card
are held against the CPU's on the same trees.  Limits as in
`test_torch_cuda_rllib.py` (`chip_smoke.py`'s rllib limits): the loss
1e-5 relative, the gradient 1e-5 by the relative norm of the
difference, the params after the step at rtol 1e-5 / atol 1e-6 wherever
the CPU gradient is 0 or above 1e-6 in magnitude, within 2 lr
elsewhere.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.bridge import params_from_numpy, tree_leaves
from ray_tpu_torch.rllib.algorithms import (
    appo,
    bc,
    cql,
    dqn,
    impala,
    marwil,
    sac,
)
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import MLPModule, params_to_numpy

TOL = {"loss": 1e-5, "grad_rel": 1e-5, "rtol": 1e-5, "atol": 1e-6}
NOISE = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the learners' card path is what "
                    "this file holds")
    return torch.device("cuda", 0)


def _case(which, rng):
    """(module, loss, lr, minibatch) at the algorithm's defaults on
    CartPole (obs 4, actions 2) or, for continuous SAC, the target env
    (obs 2, action 2)."""
    n = {"appo": 256, "impala": 256, "dqn": 64, "sac_discrete": 128,
         "sac_continuous": 128, "cql": 256, "bc": 256, "marwil": 256,
         "multi_agent_ppo": 128}[which]
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32)}
    if which in ("appo", "impala"):
        batch["advantages"] = rng.normal(size=n).astype(np.float32)
        batch["value_targets"] = (rng.normal(size=n) * 8).astype(np.float32)
        if which == "appo":
            batch["behavior_logp"] = np.log(
                rng.uniform(0.4, 1.6, n) / 2).astype(np.float32)
            return MLPModule(4, 2), appo.make_appo_loss(0.3, 0.5, 0.01), \
                5e-4, batch
        return MLPModule(4, 2), impala.make_impala_loss(0.5, 0.01), 5e-4, \
            batch
    if which in ("dqn", "sac_discrete", "cql"):
        batch["td_target"] = (rng.normal(size=n) * 2).astype(np.float32)
        if which == "dqn":
            return dqn.QMLPModule(4, 2), dqn.make_dqn_loss(), 1e-3, batch
        if which == "cql":
            return dqn.QMLPModule(4, 2), cql.make_cql_loss(1.0), 1e-3, batch
        return sac.SACModule(4, 2), sac.make_sac_loss(0.5 * np.log(2)), \
            3e-3, batch
    if which == "sac_continuous":
        batch = {"obs": rng.normal(size=(n, 2)).astype(np.float32),
                 "actions": np.tanh(rng.normal(size=(n, 2))).astype(
                     np.float32),
                 "td_target": rng.normal(size=n).astype(np.float32),
                 "noise": rng.standard_normal((n, 2)).astype(np.float32)}
        return sac.ContinuousSACModule(2, 2), \
            sac.make_continuous_sac_loss(-2.0), 3e-3, batch
    if which == "bc":
        return MLPModule(4, 2), bc.bc_loss, 1e-3, batch
    if which == "multi_agent_ppo":
        return _multi_agent_case(n)
    batch["returns"] = (rng.normal(size=n) * 3).astype(np.float32)
    return MLPModule(4, 2), marwil.make_marwil_loss(1.0, 1.0, 20.0), 1e-3, \
        batch


def _multi_agent_case(n):
    """A module of multi-agent PPO as `setup_components` builds it, on a
    minibatch as `training_step` cuts it from the runner's rollout of
    the coordination game (GAE a lane, normalised advantages)."""
    from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
        MultiAgentPPOConfig,
    )
    from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rllib.env.multi_agent import (
        MultiAgentEnvRunner,
        multi_agent_gae,
    )

    cfg = MultiAgentPPOConfig()
    loss = make_ppo_loss(cfg.clip_param, vf_loss_coeff=cfg.vf_loss_coeff,
                         entropy_coeff=cfg.entropy_coeff)
    module = MLPModule(2, 2)
    runner = MultiAgentEnvRunner("coordination", 200,
                                 {"agent_0": "pol_a", "agent_1": "pol_b"},
                                 seed=0)
    gen = torch.Generator().manual_seed(0)
    runner.set_weights({m: params_to_numpy(module.init_params(gen))
                        for m in ("pol_a", "pol_b")}, 1)
    b = runner.sample({m: module for m in ("pol_a", "pol_b")})["pol_a"]
    adv, tgt = multi_agent_gae(b, cfg.gamma, cfg.gae_lambda)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    idx = np.random.default_rng(0).permutation(len(adv))[:n]
    return module, loss, 3e-3, {
        "obs": b["obs"][idx], "actions": b["actions"][idx],
        "logp": b["logp"][idx], "advantages": adv[idx],
        "value_targets": tgt[idx]}


ALGOS = ["appo", "impala", "dqn", "sac_discrete", "sac_continuous", "cql",
         "bc", "marwil", "multi_agent_ppo"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ALGOS)
def test_card_update_matches_the_cpu_learner(card, which):
    module, loss, lr, batch = _case(which, np.random.default_rng(0))
    on_card = Learner(module, loss, lr=lr, grad_clip=None, device=card)
    on_cpu = Learner(module, loss, lr=lr, grad_clip=None, device="cpu")
    on_cpu.set_state(on_card.get_state())
    m_card, g_card = on_card._grads(batch)
    m_cpu, g_cpu = on_cpu._grads(batch)
    on_card._apply(g_card)
    on_cpu._apply(g_cpu)
    want = float(m_cpu["total_loss"])
    assert abs(float(m_card["total_loss"]) - want) <= TOL["loss"] * abs(want)
    got_g = torch.cat([g.cpu().reshape(-1) for g in g_card])
    want_g = torch.cat([g.reshape(-1) for g in g_cpu])
    rel = float((got_g - want_g).norm() / want_g.norm())
    assert rel <= TOL["grad_rel"], rel
    for got, want, g in zip(tree_leaves(on_card.get_weights_numpy()),
                            tree_leaves(on_cpu.get_weights_numpy()), g_cpu):
        g = g.numpy()
        mask = (np.abs(g) > NOISE) | (g == 0)
        np.testing.assert_allclose(got[mask], want[mask], rtol=TOL["rtol"],
                                   atol=TOL["atol"])
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=0,
                                   atol=2 * lr)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dqn", "sac_discrete", "sac_continuous"])
def test_card_target_forward_matches_the_cpu(card, which):
    """The no-grad target forwards DQN, SAC and CQL run on the learner's
    device: the card's equal the CPU's on the same trees at 1e-5."""
    module, loss, _, batch = _case(which, np.random.default_rng(1))
    gen = torch.Generator().manual_seed(3)
    trees = [params_to_numpy(module.init_params(gen)) for _ in range(2)]
    got, want = [], []
    for dev, out in ((card, got), (torch.device("cpu"), want)):
        t, o = (params_from_numpy(tree, dev) for tree in trees)
        obs = torch.from_numpy(batch["obs"]).to(dev)
        with dqn.no_grad_f32():
            if which == "dqn":
                out.append(module.forward_train(t, obs)[0].cpu())
            else:
                noise = (torch.from_numpy(batch["noise"]).to(dev)
                         if which == "sac_continuous" else None)
                out.append(sac.sac_target_terms(
                    module, which == "sac_continuous", t, o, obs,
                    noise).cpu())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-5)

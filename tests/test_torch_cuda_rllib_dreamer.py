"""Card tests of DreamerV3 (torch only: they run where the card is,
without JAX).  Marked `cuda`; each skips here, where there is no card.
Multi-agent PPO's module update is a case of
`test_torch_cuda_rllib_algos.py`.

One world-model and one actor-critic update on the card against the
CPU from one state, batch and Gumbel noise, in vector and pixel mode
(`chip_smoke.dreamer_updates_vs_cpu`: losses 1e-5 relative, gradients
1e-5 by the relative norm of the difference, params and Adam moments
at `chip_smoke.RLLIB_TOL`); the transposed convolution on the card
against the CPU (its output at rtol / atol 1e-5, it and both gradients
1e-5 by the relative norm of the difference).  Run from the repo root:
the Dreamer cases import `chip_smoke`.
"""

import pytest
import torch

from ray_tpu_torch.rllib.algorithms import dreamer
from ray_tpu_torch.rllib.core.learner import _full_f32
from ray_tpu_torch.rllib.env import env_runner

TOL = {"grad_rel": 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the learners' card path is what "
                    "this file holds")
    return torch.device("cuda", 0)


class _LocalGroup:
    """Stands in for an EnvRunnerGroup: an in-process runner answers
    `env_spec`; weights syncs are kept, not sent."""

    def __init__(self, env, num_runners, num_envs, rollout, seed=0,
                 env_kwargs=None, connector=None, **_kw):
        self.runner = env_runner.EnvRunner(env, num_envs, rollout,
                                           seed=seed, env_kwargs=env_kwargs)

    def env_spec(self):
        return self.runner.env_spec()

    def sync_weights(self, weights):
        self.runner.set_weights(weights, 1)

    def connector_state(self):
        return None

    def restore_connector_state(self, state):
        assert state is None

    def stop(self):
        pass


@pytest.mark.cuda
@pytest.mark.parametrize("pixel", [False, True], ids=["vector", "pixel"])
def test_dreamer_updates_on_the_card_match_the_cpu(card, monkeypatch,
                                                   pixel):
    import chip_smoke

    monkeypatch.setattr(dreamer, "EnvRunnerGroup", _LocalGroup)
    cfg = dreamer.DreamerConfig()
    cfg.environment("Catch-v0" if pixel else "CartPole-v1")
    cfg.env_runners(num_envs_per_env_runner=4, rollout_fragment_length=32)
    cfg.debugging(seed=0)
    cfg.learners(device=card)
    if pixel:
        cfg.conv_filters = ((8, 3, 2), (16, 3, 2))
    algo = cfg.build()
    assert algo.device == card and algo.model.pixel == pixel
    runner = algo.env_runner_group.runner
    algo._add_to_replay([runner.sample(algo._policy_module)])
    line = chip_smoke.dreamer_updates_vs_cpu(algo)
    assert line["wm_update"]["grad_rel_norm"] <= TOL["grad_rel"], line


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,k,s", [(10, 5, 3, 2), (10, 5, 4, 2),
                                     (84, 84, 3, 2), (84, 84, 4, 2)])
def test_transposed_convolution_on_the_card_matches_the_cpu(card, H, W, k,
                                                            s):
    gen = torch.Generator().manual_seed(H + k)
    x = torch.randn((16, H, W, 32), generator=gen)
    w = torch.randn((k, k, 32, 16), generator=gen) * 0.1
    cot = torch.randn((16, H * s, W * s, 16), generator=gen)
    out = {}
    for dev in (card, torch.device("cpu")):
        tx = x.to(dev).requires_grad_(True)
        tw = w.to(dev).requires_grad_(True)
        with _full_f32():
            y = dreamer.conv_transpose_same(tx, tw, s)
            gx, gw = torch.autograd.grad((y * cot.to(dev)).sum(), (tx, tw))
        out[dev.type] = [t.detach().cpu() for t in (y, gx, gw)]
    assert tuple(out["cuda"][0].shape) == (16, H * s, W * s, 16)
    # the gradients sum up to 16 x 84 x 84 products an element: held by
    # the relative norm of the difference at the learners' gradient
    # limit, the output element by element too
    for got, want in zip(out["cuda"], out["cpu"]):
        rel = float((got - want).norm() / want.norm())
        assert rel <= TOL["grad_rel"], rel
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)

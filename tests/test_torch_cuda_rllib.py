"""Card tests of rllib's learner (torch only: they run where the card
is, without JAX).  Marked `cuda`; each skips here, where there is no
card.

One learner update on the card against the plain CPU learner from the
same params, optimizer state and minibatch, for both modules: CartPole's
`MLPModule` at its default widths and the `CNNModule` at its defaults on
Atari's stacked frame (84, 84, 4).  Held at `chip_smoke.py`'s rllib
limits: the loss 1e-5 relative, the gradient 1e-5 by the relative norm
of the difference, the params after the step at rtol 1e-5 / atol 1e-6
wherever the CPU gradient is 0 or its magnitude above 1e-6, and within
2 lr elsewhere (a flip of Adam's step sign on a rounding-level gradient
moves a param by 2 lr).  PyTorch's default TF32 for cuDNN is on around
the card's update: the learner's own scope keeps its convolutions f32,
and gives the setting back.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.bridge import tree_leaves
from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import CNNModule, MLPModule

TOL = {"loss": 1e-5, "grad_rel": 1e-5, "rtol": 1e-5, "atol": 1e-6}
NOISE = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the learner's card path is what "
                    "this file holds")
    return torch.device("cuda", 0)


def _batch(n, shape, actions, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.random((n, *shape), dtype=np.float32),
        "actions": rng.integers(0, actions, n).astype(np.int32),
        "logp": np.log(rng.uniform(0.5, 1.5, n) / actions
                       ).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": (rng.normal(size=n) * 8).astype(np.float32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_card_update_matches_the_cpu_learner(card, which):
    if which == "mlp":
        module, shape, n = MLPModule(4, 2), (4,), 2048
    else:
        module, shape, n = CNNModule((84, 84, 4), 3), (84, 84, 4), 512
    loss = make_ppo_loss()
    on_card = Learner(module, loss, lr=3e-4, grad_clip=0.5, device=card)
    on_cpu = Learner(module, loss, lr=3e-4, grad_clip=0.5, device="cpu")
    on_cpu.set_state(on_card.get_state())
    batch = _batch(n, shape, module.num_actions)
    ambient = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        m_card, g_card = on_card._grads(batch)
        assert torch.backends.cudnn.allow_tf32  # the scope gave it back
    finally:
        torch.backends.cudnn.allow_tf32 = ambient
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
                                   atol=2 * 3e-4)

"""The reference's DreamerV3 pixel case on the port, with the learner
on the CPU (in a file of its own: it trains 20 iterations of 16 updates
through the conv encoder and the transposed-convolution decoder).

`tests/test_rllib.py:1402-1430`: Catch at 10 x 5, filters ((8, 3, 2),
(16, 3, 2)), deter 64, lr 1e-3, segments 16 x 9: the reconstruction
loss falls below 0.95 of the first iteration's and below 1.9 (an
all-zero prediction scores ~2.0), and the imagination policy beats a
random one (~ -0.6) with a best return above -0.55.  The gates are the
reference's.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from test_torch_waits import within


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    yield
    rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small convolutions: one intra-op thread, as the other learner
    files pin, since the parallel test run's files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dreamer_pixel_world_model(cluster):
    """DreamerV3 pixel mode: conv encoder + deconv decoder learn the
    frames (recon falls) and the imagination policy beats random."""
    from ray_tpu_torch.rllib.algorithms.dreamer import DreamerConfig

    cfg = DreamerConfig()
    cfg.environment("Catch-v0")
    cfg.env_runners(num_env_runners=1, num_envs_per_env_runner=16,
                    rollout_fragment_length=16)
    cfg.debugging(seed=0)
    cfg.learners(device="cpu")
    cfg.conv_filters = ((8, 3, 2), (16, 3, 2))
    cfg.deter_size = 64
    cfg.lr = 1e-3
    cfg.batch_length = 9
    cfg.batch_segments = 16
    cfg.num_updates_per_iter = 16
    algo = cfg.build()
    try:
        assert algo.model.pixel
        first = within(60.0, algo.train)
        best = -1.0
        for _ in range(19):
            r = within(60.0, algo.train)
            ret = r.get("episode_return_mean")
            if ret is not None and np.isfinite(ret):
                best = max(best, ret)
        # all-zero prediction scores ~2.0; the decoder must clearly
        # beat it, and the policy must beat random (~ -0.6)
        assert r["recon_loss"] < first["recon_loss"] * 0.95
        assert r["recon_loss"] < 1.9, r["recon_loss"]
        assert best > -0.55, best
    finally:
        algo.stop()

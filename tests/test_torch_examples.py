"""The port's example programs (`ray_tpu_torch.examples.mnist` and
`ppo_pixels`, the baseline-config parity demos) on one port cluster,
with the reference's own cases and gates (`tests/test_examples.py:15-24`
and `:60-80`) and the workers and learner on the CPU.

`mnist`: BASELINE config #1, 2 data-parallel workers of `CudaTrainer`
in collective mode training a torch MLP on the seeded synthetic teacher
task: no error, 4 epochs, accuracy above 0.5 (chance is 0.1).
`ppo_pixels`: BASELINE config #3's wiring, PPO with the CNN encoder on
Catch: the example's config beats a random policy decisively (best
return >= 0.35) within 45 iterations.  Both examples' data are the
reference's, made from seeds (`make_dataset` is a copy).  Every wait
has a limit.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from test_torch_waits import within


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=3, num_cpus=8, ignore_reinit_error=True)
    yield
    rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The learner's convolutions are small: one intra-op thread, as the
    other learner files pin, since the parallel run's files share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mnist_dataset_equals_the_references():
    from ray_tpu.examples import mnist as jmnist
    from ray_tpu_torch.examples import mnist

    for n, seed in ((64, 0), (100, 3)):
        for got, want in zip(mnist.make_dataset(n, seed),
                             jmnist.make_dataset(n, seed)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_mnist_fashion_ddp(cluster, tmp_path):
    """BASELINE config #1: 2-worker data-parallel MLP training."""
    from ray_tpu_torch.examples import mnist

    result = within(240.0, lambda: mnist.run(
        num_workers=2, epochs=4, storage_path=str(tmp_path / "mnist"),
        device="cpu"))
    assert result.error is None
    assert result.metrics["epoch"] == 3
    # the synthetic teacher task is learnable: well above 10% chance
    assert result.metrics["accuracy"] > 0.5, result.metrics
    # the loss fell from the first epoch's
    history = [m["loss"] for m in result.metrics_history]
    assert history[-1] < history[0], history


def test_ppo_pixels_example(cluster):
    """BASELINE config #3 parity demo: the example's OWN wiring must
    produce a learning signal, not merely run.  Random policy on Catch
    scores ~0 (±small); a few iterations of the example's exact config
    must beat that margin decisively."""
    from ray_tpu_torch.examples import ppo_pixels

    result = within(240.0, lambda: ppo_pixels.run(
        iterations=45, target_return=0.35, seed=0, device="cpu"))
    assert np.isfinite(result["total_loss"])
    assert result["num_env_steps_sampled"] > 0
    assert result["best_return"] >= 0.35, (
        f"no learning signal from the example config: best return "
        f"{result['best_return']}"
    )

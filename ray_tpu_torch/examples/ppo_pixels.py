"""BASELINE config #3 parity demo: PPO on pixels with the new-stack
Learner API.

Reference: "RLlib PPO Atari Breakout (new Learner API, 4 learner
workers)" — ALE isn't installable in this image, so the procedural
pixel env (`CatchPixelEnv`) stands in: (H, W, C) image observations
through the CNN encoder, the same stack an Atari run uses
(`wrap_atari_connectors` supplies the warp/stack pipeline for real
gymnasium image envs).

The learner runs on `device`: the card unless the caller asks for the
CPU (`run(device="cpu")`, as the tests do); without a card the default
raises before anything starts.

Run: `python -m ray_tpu_torch.examples.ppo_pixels` (inside `rt.init`), or
call `run()` from tests.
"""

from __future__ import annotations

from typing import Dict


def run(iterations: int = 45, *, num_env_runners: int = 1,
        num_learners: int = 0, target_return: float = 0.6,
        seed: int = 0, device=None) -> Dict[str, float]:
    """Train PPO+CNN on the pixel env until it catches reliably;
    returns the final metrics (episode_return_mean ~1.0 = perfect)."""
    import numpy as np

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib import CNNModule, PPOConfig

    device = resolve_device(device)

    cfg = (PPOConfig()
           .environment("Catch-v0")
           .env_runners(num_env_runners=num_env_runners,
                        num_envs_per_env_runner=16,
                        rollout_fragment_length=32)
           .training(lr=1e-3, minibatch_size=256, num_epochs=4,
                     model={"conv_filters": ((16, 3, 2), (32, 3, 2)),
                            "hidden": (128,)})
           .learners(num_learners=num_learners, device=device)
           .debugging(seed=seed))
    algo = cfg.build()
    try:
        assert isinstance(algo.module, CNNModule)  # pixel path engaged
        best = -1.0
        result: Dict[str, float] = {}
        for _ in range(iterations):
            result = algo.train()
            ret = result.get("episode_return_mean")
            if ret is not None and np.isfinite(ret):
                best = max(best, float(ret))
            if best >= target_return:
                break
        result["best_return"] = best
        return result
    finally:
        algo.stop()


if __name__ == "__main__":
    import json

    import ray_tpu_torch as rt

    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    try:
        out = run()
        print(json.dumps({k: v for k, v in out.items()
                          if isinstance(v, (int, float))}, indent=2))
    finally:
        rt.shutdown()

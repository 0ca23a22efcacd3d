from ray_tpu_torch.rllib.env.env_runner import EnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.envs import (
    CartPoleVectorEnv,
    GymnasiumVectorEnv,
    VectorEnv,
    make_vector_env,
)

__all__ = [
    "CartPoleVectorEnv",
    "EnvRunner",
    "EnvRunnerGroup",
    "GymnasiumVectorEnv",
    "VectorEnv",
    "make_vector_env",
]

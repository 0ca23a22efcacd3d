from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModule

__all__ = ["Learner", "LearnerGroup", "MLPModule", "RLModule"]

"""RL library (reference: top-level `rllib/`, new API stack only).

EnvRunner actors sample with pure-numpy policies on CPU; the Learner
owns a tree of torch tensors on its device (the card unless the caller
asks for the CPU) and an eager update — scaled over a learner gang of
mesh devices (`num_learner_devices`) or via DDP learner actors on the
CPU with host-collective gradient allreduce (the CPU-fleet path).
Production shape (BASELINE config #3): the runner fleet ships sample
batches as object-plane references into the learner with async
sample/train overlap and exactly-once `SampleLedger` accounting.

Every algorithm of the reference is here: PPO, with its modules
(`MLPModule`, `CNNModule`), learner, environments, runners, connectors
and the fleet bench; IMPALA and APPO (v-trace on the driver); DQN and
SAC, discrete and continuous (replay, target networks kept on the
learner's device); CQL, BC and MARWIL (offline datasets); multi-agent
PPO (a learner group a module over dict-keyed envs,
`env/multi_agent.py`); and DreamerV3 (an RSSM world model and an
actor-critic trained in imagination, vector or pixel observations,
its two updates eager on the learner's device).

No module here imports torch at load: runner actors unpickle modules
and connectors, and stay numpy-only.
"""

from ray_tpu_torch.rllib.algorithms import (
    APPO,
    BC,
    CQL,
    DQN,
    IMPALA,
    MARWIL,
    PPO,
    SAC,
    Algorithm,
    AlgorithmConfig,
    APPOConfig,
    BCConfig,
    CQLConfig,
    DQNConfig,
    Dreamer,
    DreamerConfig,
    IMPALAConfig,
    MARWILConfig,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    PPOConfig,
    SACConfig,
)
from ray_tpu_torch.rllib.connectors import (
    ConnectorPipeline,
    ConnectorV2,
    FrameStack,
    ImagePreprocess,
    MeanStdObsFilter,
    ObsClip,
    RewardClip,
    wrap_atari_connectors,
)
from ray_tpu_torch.rllib.core import Learner, LearnerGroup, MLPModule, RLModule
from ray_tpu_torch.rllib.core.learner import make_data_mesh
from ray_tpu_torch.rllib.core.rl_module import CNNModule, make_default_module
from ray_tpu_torch.rllib.env import (
    CartPoleVectorEnv,
    EnvRunner,
    EnvRunnerGroup,
    VectorEnv,
)
from ray_tpu_torch.rllib.env.env_runner_group import (
    DuplicateSampleError,
    SampleLedger,
)
from ray_tpu_torch.rllib.env.envs import (
    CatchPixelEnv,
    ContinuousTargetEnv,
    PendulumVectorEnv,
)

__all__ = [
    "Algorithm",
    "ConnectorPipeline",
    "ConnectorV2",
    "MeanStdObsFilter",
    "ObsClip",
    "RewardClip",
    "AlgorithmConfig",
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "CQL",
    "CQLConfig",
    "CartPoleVectorEnv",
    "CatchPixelEnv",
    "CNNModule",
    "ContinuousTargetEnv",
    "FrameStack",
    "ImagePreprocess",
    "PendulumVectorEnv",
    "make_default_module",
    "wrap_atari_connectors",
    "DQN",
    "DQNConfig",
    "Dreamer",
    "DreamerConfig",
    "IMPALA",
    "IMPALAConfig",
    "SAC",
    "SACConfig",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "EnvRunner",
    "EnvRunnerGroup",
    "Learner",
    "LearnerGroup",
    "DuplicateSampleError",
    "MLPModule",
    "PPO",
    "PPOConfig",
    "RLModule",
    "SampleLedger",
    "VectorEnv",
    "make_data_mesh",
]

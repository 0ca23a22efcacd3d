"""AlgorithmConfig: fluent config-as-object.

Reference: `rllib/algorithms/algorithm_config.py` — the chained
`.environment().env_runners().training().learners()` builder surface.

The port's one change: the learner's device, `learners(device=...)`
(`learner_device`).  None means the card, as for every entry point of
the port; tests pass "cpu".  It plays the part `JAX_PLATFORMS` plays
for the JAX package's learner.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple, Type


class AlgorithmConfig:
    def __init__(self):
        self.env: Any = "CartPole-v1"
        self.env_kwargs: Dict[str, Any] = {}
        self.num_env_runners: int = 2
        self.num_envs_per_env_runner: int = 8
        self.rollout_fragment_length: int = 64
        self.num_learners: int = 0
        self.lr: float = 3e-4
        self.grad_clip: Optional[float] = 0.5
        self.train_batch_size: int = 0  # derived if 0
        self.minibatch_size: int = 256
        self.num_epochs: int = 4
        self.gamma: float = 0.99
        self.seed: int = 0
        self.model: Dict[str, Any] = {"hidden": (64, 64)}
        self.mesh: Any = None  # list of devices for the learner gang
        #: learner gang width: >=2 builds a mesh over that many local
        #: devices and splits every minibatch across it (alternative to
        #: `mesh`; exclusive with num_learners DDP actors)
        self.num_learner_devices: int = 0
        #: the local learner's device; None is the card (DDP learner
        #: actors run on the CPU whatever it says)
        self.learner_device: Any = None
        # env<->module connector pipeline FACTORY (reference:
        # config.env_runners(env_to_module_connector=...)); a factory —
        # not an instance — so each runner actor builds its own state
        self.env_to_module_connector: Any = None
        #: async sample/train overlap (PPO): runners keep sampling
        #: epoch N+1 while the learner gang updates on epoch N; weights
        #: broadcast non-blocking by reference.  Rollouts are then
        #: boundedly stale (~inflight_rollouts_per_runner versions) —
        #: PPO's ratio clip absorbs it (the reference's APPO/IMPALA
        #: shape, applied to the PPO loss)
        self.sample_train_overlap: bool = False
        #: pipelined sample_ref() calls per runner on the async path
        #: (reference: max_requests_in_flight_per_env_runner)
        self.inflight_rollouts_per_runner: int = 2
        #: replacement runners deterministically replay the dead
        #: incarnation's weights history (sync fleets only) — a
        #: kill-storm run consumes bit-identical batches to an
        #: unkilled control run (chaos-test contract)
        self.deterministic_replacement: bool = False
        #: compiled-DAG fast plane for the learner round: each runner
        #: hosts a resident sample loop, rollout batches ride shm
        #: tensor channels runner->learner and weights broadcasts ride
        #: reverse channels — the per-call actor RPC machinery leaves
        #: the hot path entirely (requires sample_train_overlap; see
        #: docs/compiled_dag.md)
        self.use_compiled_dag: bool = False

    # -- fluent sections (each returns self, reference-style) ----------
    def environment(self, env: Any = None, *, env_config: Optional[Dict] = None,
                    **kwargs) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config:
            self.env_kwargs.update(env_config)
        self._apply(kwargs)
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    **kwargs) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        self._apply(kwargs)
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 num_learner_devices: Optional[int] = None,
                 device: Any = None,
                 **kwargs) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if num_learner_devices is not None:
            self.num_learner_devices = num_learner_devices
        if device is not None:
            self.learner_device = device
        self._apply(kwargs)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        self._apply(kwargs)
        return self

    def debugging(self, *, seed: Optional[int] = None, **kwargs):
        if seed is not None:
            self.seed = seed
        self._apply(kwargs)
        return self

    def rl_module(self, *, model_config: Optional[Dict] = None, **kwargs):
        if model_config:
            self.model.update(model_config)
        self._apply(kwargs)
        return self

    def _apply(self, kwargs: Dict[str, Any]):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown config key {k!r}")
            setattr(self, k, v)

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    @property
    def algo_class(self) -> Type:
        raise NotImplementedError

    def build(self):
        from ray_tpu_torch.util.usage_stats import record_library_usage

        record_library_usage("rllib")
        """Reference: `AlgorithmConfig.build_algo`."""
        per_step = self.num_env_runners * self.num_envs_per_env_runner
        if self.train_batch_size > 0:
            # user-specified total rollout per iteration: derive the
            # fragment length from it (the quantity sampling actually
            # consumes), so the setting has effect instead of being
            # silently ignored
            if self.train_batch_size % per_step:
                raise ValueError(
                    f"train_batch_size={self.train_batch_size} must be a "
                    f"multiple of num_env_runners*num_envs_per_env_runner "
                    f"({per_step})"
                )
            self.rollout_fragment_length = self.train_batch_size // per_step
        else:
            self.train_batch_size = per_step * self.rollout_fragment_length
        if self.use_compiled_dag:
            if not self.sample_train_overlap:
                raise ValueError(
                    "use_compiled_dag rides the overlap learner round "
                    "(resident sample loops feed channels continuously) "
                    "— set training(sample_train_overlap=True) with it"
                )
            if self.deterministic_replacement:
                raise ValueError(
                    "deterministic_replacement replays the weights-ref "
                    "history over the actor-call path; the channel "
                    "plane broadcasts by value — use one or the other"
                )
            if self.env_to_module_connector is not None:
                raise ValueError(
                    "use_compiled_dag runs a resident loop on every "
                    "runner actor, and connector-state aggregation "
                    "needs the actor-call path that loop occupies — "
                    "use the ref stream with connector pipelines"
                )
        return self.algo_class(self.copy())

    build_algo = build

"""Serve configuration dataclasses.

Mirrors the reference's `python/ray/serve/config.py` (`DeploymentConfig`,
`AutoscalingConfig`, `HTTPOptions`) so users find the same knobs; kept as
plain dataclasses (the reference uses pydantic — a validation detail, not
a capability).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.slo import SLOConfig


@dataclass
class AutoscalingConfig:
    """Reference: `serve/config.py` AutoscalingConfig — replica count is
    driven by the average number of ongoing requests per replica.

    Setting either SLO field switches the deployment to the
    **SLO-driven policy** (`serve/autoscaling.py`): replica counts are
    computed from the controller-collected per-replica engine signals
    (queue depth, TTFT EMA, shed/rejection counters piggybacked on
    health checks) instead of router-pushed in-flight counts —

    - `target_ttft_s`: keep the worst replica's time-to-first-token
      EMA at or below this;
    - `target_queue_depth`: keep the mean per-replica backlog
      (engine queued + active) at or below this;
    - `hysteresis`: dead band around the SLO — the load ratio must
      leave [1-h, 1+h] before the target moves, so jitter at the
      boundary can't flap replicas.

    `upscale_delay_s` / `downscale_delay_s` stay the scale cooldowns
    for both policies."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.2
    look_back_period_s: float = 2.0
    # SLO-driven policy (either one opts in)
    target_ttft_s: Optional[float] = None
    target_queue_depth: Optional[float] = None
    hysteresis: float = 0.1

    def has_slo(self) -> bool:
        return (self.target_ttft_s is not None
                or self.target_queue_depth is not None)

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        if current <= 0:
            return max(self.min_replicas, 1)
        per_replica = total_ongoing / current
        desired = current * per_replica / max(self.target_ongoing_requests, 1e-9)
        import math

        desired = int(math.ceil(desired))
        return max(self.min_replicas, min(self.max_replicas, desired))


@dataclass
class DeploymentConfig:
    """Reference: `serve/config.py` DeploymentConfig."""

    num_replicas: int = 1
    max_ongoing_requests: int = 16
    max_queued_requests: int = -1  # -1 == unbounded
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    user_config: Optional[Any] = None
    # per-deployment SLOs (serve/slo.py): the controller tracks
    # multi-window burn rates against these from the replica-shipped
    # ledger counters; surfaced via rt.slo_status() / /api/slo
    slo_config: Optional[SLOConfig] = None

    def initial_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return max(self.autoscaling_config.min_replicas, 1)
        return self.num_replicas


@dataclass
class LLMEngineConfig:
    """Knobs for the continuous-batching LLM engine
    (`serve/llm_engine.py`), validated once and expanded into
    `LlamaEngine(**engine_kwargs())` by the serving wrappers
    (`examples/serve_llm.py` ContinuousLlamaService).

    The decode/quantization plane:
    - `decode_kernel`: "auto" (what the engine resolves to: the fused
      CUDA append + paged decode attention kernel of
      `ops/paged_attention.py`, or its plain version for a CPU engine),
      "kernel" (the same, named), or "gather" (force the reference
      route).  The JAX package's "pallas" is the port's "kernel".
    - `kv_dtype`: "model" stores KV in the compute dtype; "int8"
      stores per-row-scaled int8 (half the pool bytes, f32 scale
      sidecar, dequant fused in the kernel / applied on gather).
    - `weight_dtype`: "model" serves the params as given; "int8"
      applies `llama.quantize_weights_int8` at replica init
      (per-output-channel scales, matmuls dequant on the fly).
    - `chunk_cache_cap`: the LRU bound of the engine's chunk steppers,
      one per gather width (on the card's kernel route, one CUDA graph
      of the whole decode chunk each).
    """

    slots: int = 32
    chunk: int = 8
    max_len: Optional[int] = None
    block_size: int = 16
    kv_blocks: Optional[int] = None
    prefix_cache: bool = True
    max_queued: Optional[int] = None
    decode_kernel: str = "auto"
    kv_dtype: str = "model"
    weight_dtype: str = "model"
    chunk_cache_cap: int = 8

    def validate(self) -> "LLMEngineConfig":
        if self.decode_kernel not in ("auto", "kernel", "gather"):
            raise ValueError(
                f"decode_kernel={self.decode_kernel!r} not in "
                "('auto', 'kernel', 'gather')"
            )
        if self.kv_dtype not in ("model", "int8"):
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} not in ('model', 'int8')"
            )
        if self.weight_dtype not in ("model", "int8"):
            raise ValueError(
                f"weight_dtype={self.weight_dtype!r} not in "
                "('model', 'int8')"
            )
        if self.slots < 1:
            raise ValueError(f"slots={self.slots} must be >= 1")
        if self.chunk < 1:
            raise ValueError(f"chunk={self.chunk} must be >= 1")
        if self.block_size < 1:
            raise ValueError(
                f"block_size={self.block_size} must be >= 1"
            )
        if self.chunk_cache_cap < 1:
            raise ValueError(
                f"chunk_cache_cap={self.chunk_cache_cap} must be >= 1"
            )
        return self

    def engine_kwargs(self) -> Dict[str, Any]:
        """Kwargs for `LlamaEngine(...)` — everything except
        `weight_dtype`, which the serving wrapper applies to the params
        BEFORE constructing the engine."""
        return {
            "slots": self.slots,
            "chunk": self.chunk,
            "max_len": self.max_len,
            "block_size": self.block_size,
            "kv_blocks": self.kv_blocks,
            "prefix_cache": self.prefix_cache,
            "max_queued": self.max_queued,
            "decode_kernel": self.decode_kernel,
            "kv_dtype": self.kv_dtype,
            "chunk_cache_cap": self.chunk_cache_cap,
        }


@dataclass
class ReplicaConfig:
    """What it takes to construct one replica: the callable plus its init
    args and per-replica resources (reference: `serve/config.py`
    ReplicaConfig)."""

    import_blob: bytes = b""  # cloudpickled class or function
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    resources: Dict[str, float] = field(default_factory=dict)


@dataclass
class HTTPOptions:
    """Reference: `serve/config.py` HTTPOptions."""

    host: str = "127.0.0.1"
    port: int = 8000


@dataclass
class GRPCOptions:
    """Reference: `serve/config.py` gRPCOptions; here the generic
    bytes-through proxy (`serve/grpc_proxy.py`), so no servicer
    function list is needed."""

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral

"""Declarative Serve config schema for REST / CLI deploys.

Reference: `python/ray/serve/schema.py` — `ServeDeploySchema` /
`ServeApplicationSchema` / `DeploymentSchema` / `RayActorOptionsSchema`,
the pydantic-validated document accepted by `serve deploy` and the
dashboard REST API.  Same document shape here (multi-app config with
per-deployment overrides applied on top of the code's `@serve.deployment`
settings), validated with pydantic v2.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, ConfigDict, Field, field_validator

from ray_tpu_torch.serve.config import AutoscalingConfig, LLMEngineConfig


class LLMEngineSchema(BaseModel):
    """Declarative knobs for the continuous-batching LLM engine —
    the validated form of `config.LLMEngineConfig`, accepted in a
    deployment's `user_config` (ContinuousLlamaService applies it via
    `engine_config=`) or anywhere a deploy document wants to pin the
    decode/quantization plane (`decode_kernel`, `kv_dtype`,
    `weight_dtype`) alongside the batching shape; `chunk_cache_cap`
    bounds the engine's LRU of chunk steppers (one CUDA graph a gather
    width on the card)."""

    model_config = ConfigDict(extra="forbid")

    slots: int = Field(default=32, ge=1)
    chunk: int = Field(default=8, ge=1)
    max_len: Optional[int] = Field(default=None, ge=2)
    block_size: int = Field(default=16, ge=1)
    kv_blocks: Optional[int] = Field(default=None, ge=1)
    prefix_cache: bool = True
    max_queued: Optional[int] = Field(default=None, ge=0)
    decode_kernel: str = "auto"
    kv_dtype: str = "model"
    weight_dtype: str = "model"
    chunk_cache_cap: int = Field(default=8, ge=1)

    @field_validator("decode_kernel")
    @classmethod
    def _kernel_valid(cls, v):
        if v not in ("auto", "kernel", "gather"):
            raise ValueError(
                'decode_kernel must be "auto", "kernel" or "gather"'
            )
        return v

    @field_validator("kv_dtype", "weight_dtype")
    @classmethod
    def _dtype_valid(cls, v):
        if v not in ("model", "int8"):
            raise ValueError('dtype knobs must be "model" or "int8"')
        return v

    def to_config(self) -> LLMEngineConfig:
        return LLMEngineConfig(**self.model_dump()).validate()


class RayActorOptionsSchema(BaseModel):
    """Per-replica actor resources (reference: `schema.py`
    RayActorOptionsSchema)."""

    model_config = ConfigDict(extra="forbid")

    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    memory: Optional[float] = None
    resources: Dict[str, float] = Field(default_factory=dict)
    runtime_env: Optional[Dict[str, Any]] = None

    def to_actor_options(self) -> Dict[str, Any]:
        """Option-style dict splatted into the replica actor's
        `.options(**...)` (the shape `@serve.deployment
        ray_actor_options` takes) — runtime_env rides through as a real
        actor option, not a resource."""
        out: Dict[str, Any] = {}
        for f in ("num_cpus", "num_gpus", "memory", "runtime_env"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        if self.resources:
            out["resources"] = dict(self.resources)
        return out


class AutoscalingConfigSchema(BaseModel):
    model_config = ConfigDict(extra="forbid")

    min_replicas: int = Field(default=1, ge=0)
    max_replicas: int = Field(default=1, ge=1)
    target_ongoing_requests: float = Field(default=2.0, gt=0)
    upscale_delay_s: float = Field(default=0.5, ge=0)
    downscale_delay_s: float = Field(default=2.0, ge=0)
    metrics_interval_s: float = Field(default=0.2, gt=0)
    look_back_period_s: float = Field(default=2.0, gt=0)
    # SLO-driven policy (serve/autoscaling.py): either target opts in
    target_ttft_s: Optional[float] = Field(default=None, gt=0)
    target_queue_depth: Optional[float] = Field(default=None, gt=0)
    hysteresis: float = Field(default=0.1, ge=0, lt=1)

    @field_validator("max_replicas")
    @classmethod
    def _max_ge_min(cls, v, info):
        if "min_replicas" in info.data and v < info.data["min_replicas"]:
            raise ValueError("max_replicas must be >= min_replicas")
        return v

    def to_config(self) -> AutoscalingConfig:
        return AutoscalingConfig(**self.model_dump())


class DeploymentSchema(BaseModel):
    """Overrides for one named deployment (reference: `schema.py`
    DeploymentSchema).  Only fields the user sets are applied on top of
    the code's `@serve.deployment` values."""

    model_config = ConfigDict(extra="forbid")

    name: str
    num_replicas: Union[int, str, None] = None
    max_ongoing_requests: Optional[int] = Field(default=None, gt=0)
    max_queued_requests: Optional[int] = None
    autoscaling_config: Optional[AutoscalingConfigSchema] = None
    user_config: Optional[Any] = None
    health_check_period_s: Optional[float] = Field(default=None, gt=0)
    health_check_timeout_s: Optional[float] = Field(default=None, gt=0)
    graceful_shutdown_timeout_s: Optional[float] = Field(default=None, ge=0)
    ray_actor_options: Optional[RayActorOptionsSchema] = None

    @field_validator("num_replicas")
    @classmethod
    def _replicas_valid(cls, v):
        if isinstance(v, str) and v != "auto":
            raise ValueError('num_replicas must be an int or "auto"')
        if isinstance(v, int) and v < 0:
            raise ValueError("num_replicas must be >= 0")
        return v

    def override_kwargs(self) -> Dict[str, Any]:
        """Kwargs for `Deployment.options()` — only the fields set."""
        out: Dict[str, Any] = {}
        for f in ("num_replicas", "max_ongoing_requests",
                  "max_queued_requests", "user_config",
                  "health_check_period_s", "health_check_timeout_s",
                  "graceful_shutdown_timeout_s"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        if self.autoscaling_config is not None:
            out["autoscaling_config"] = self.autoscaling_config.to_config()
        if out.get("num_replicas") == "auto":
            out.pop("num_replicas")
            out.setdefault(
                "autoscaling_config",
                AutoscalingConfig(min_replicas=1, max_replicas=8),
            )
        if self.ray_actor_options is not None:
            out["ray_actor_options"] = (
                self.ray_actor_options.to_actor_options()
            )
        return out


class ServeApplicationSchema(BaseModel):
    """One application: where to import it and what to override
    (reference: `schema.py` ServeApplicationSchema)."""

    model_config = ConfigDict(extra="forbid")

    name: str = "default"
    route_prefix: Optional[str] = "/"
    import_path: str
    import_dirs: List[str] = Field(default_factory=list)
    args: Dict[str, Any] = Field(default_factory=dict)
    deployments: List[DeploymentSchema] = Field(default_factory=list)

    @field_validator("import_path")
    @classmethod
    def _import_path_valid(cls, v):
        mod, sep, var = v.partition(":")
        if not (mod and sep and var):
            raise ValueError(
                'import_path must be "module.submodule:variable"'
            )
        return v

    @field_validator("deployments")
    @classmethod
    def _unique_names(cls, v):
        names = [d.name for d in v]
        if len(names) != len(set(names)):
            raise ValueError("duplicate deployment names in overrides")
        return v


class ServeDeploySchema(BaseModel):
    """The whole declarative deploy document (reference: `schema.py`
    ServeDeploySchema): a list of applications with unique names and
    non-overlapping route prefixes."""

    model_config = ConfigDict(extra="forbid")

    applications: List[ServeApplicationSchema]

    @field_validator("applications")
    @classmethod
    def _apps_consistent(cls, v):
        names = [a.name for a in v]
        if len(names) != len(set(names)):
            raise ValueError("duplicate application names")
        prefixes = [a.route_prefix for a in v if a.route_prefix]
        if len(prefixes) != len(set(prefixes)):
            raise ValueError("duplicate route_prefix across applications")
        return v


# ----------------------------------------------------------------------
# schema -> running application
# ----------------------------------------------------------------------
def _rewrite_with_overrides(app, overrides: Dict[str, Dict[str, Any]]):
    """Return a copy of the bound graph with `.options(**ov)` applied to
    every deployment named in `overrides` (reference: config overrides
    merged over code defaults in `application_state.py` build)."""
    from ray_tpu_torch.serve.api import Application

    def _rewrite(node: Application) -> Application:
        args = tuple(
            _rewrite(a) if isinstance(a, Application) else a
            for a in node.args
        )
        kwargs = {
            k: _rewrite(v) if isinstance(v, Application) else v
            for k, v in node.kwargs.items()
        }
        d = node.deployment
        ov = overrides.get(d.name)
        if ov:
            d = d.options(**ov)
        return Application(d, args, kwargs)

    return _rewrite(app)


def build_application(schema: ServeApplicationSchema):
    """Import the app named by import_path, apply argument binding and
    per-deployment overrides.  Returns the Application to pass to
    `serve.run`."""
    added = []
    for d in schema.import_dirs:
        if d not in sys.path:
            sys.path.insert(0, d)
            added.append(d)
    try:
        mod_name, _, var = schema.import_path.partition(":")
        if mod_name in sys.modules:
            # redeploy must see edited code, not the import cache
            mod = importlib.reload(sys.modules[mod_name])
        else:
            mod = importlib.import_module(mod_name)
        target = getattr(mod, var)
    finally:
        for d in added:
            try:
                sys.path.remove(d)
            except ValueError:
                pass
    from ray_tpu_torch.serve.api import Application, Deployment

    if isinstance(target, Deployment):
        target = target.bind(**schema.args)
    elif callable(target) and not isinstance(target, Application):
        # app-builder function taking the args dict (reference:
        # `serve/api.py` build callable support)
        target = target(schema.args) if schema.args else target({})
    if not isinstance(target, Application):
        raise TypeError(
            f"{schema.import_path} is not an Application/Deployment/builder"
        )
    overrides = {
        d.name: d.override_kwargs() for d in schema.deployments
    }
    if overrides:
        target = _rewrite_with_overrides(target, overrides)
    return target


def deploy_from_schema(doc: Union[ServeDeploySchema, dict]) -> List[str]:
    """Validate + deploy every application in the document; returns the
    deployed app names.  The REST `PUT /api/serve/applications` body
    lands here (reference: `dashboard/modules/serve/serve_head.py`)."""
    from ray_tpu_torch import serve

    if not isinstance(doc, ServeDeploySchema):
        doc = ServeDeploySchema.model_validate(doc)
    names = []
    for app_schema in doc.applications:
        app = build_application(app_schema)
        serve.run(
            app,
            name=app_schema.name,
            route_prefix=app_schema.route_prefix,
        )
        names.append(app_schema.name)
    return names

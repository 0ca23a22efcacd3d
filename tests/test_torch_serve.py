"""The port's serve plane (`ray_tpu_torch.serve`) held against the JAX
package's: the same seeded inputs go through `ray_tpu.serve.X` and
`ray_tpu_torch.serve.X` and the outputs compare equal — config and
schema validation (accepted and rejected), the autoscaling decisions,
the SLO burn-rate tracker, the router's pow-2 pick under a seeded RNG
with reported depths, and `@serve.batch` grouping.  Then a plain
deployment through a handle and over HTTP on the port's runtime.

Every blocking call carries its own timeout.
"""

import asyncio
import dataclasses
import json
import random
import urllib.request

import numpy as np
import pytest

from ray_tpu.exceptions import BackPressureError as JaxBackPressureError
from ray_tpu.serve import autoscaling as j_autoscaling
from ray_tpu.serve import batching as j_batching
from ray_tpu.serve import config as j_config
from ray_tpu.serve import router as j_router
from ray_tpu.serve import schema as j_schema
from ray_tpu.serve import slo as j_slo
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import BackPressureError
from ray_tpu_torch.serve import autoscaling as t_autoscaling
from ray_tpu_torch.serve import batching as t_batching
from ray_tpu_torch.serve import config as t_config
from ray_tpu_torch.serve import router as t_router
from ray_tpu_torch.serve import schema as t_schema
from ray_tpu_torch.serve import slo as t_slo


def _outcome(fn, *args, **kwargs):
    """("ok", value) or ("error", exception type name): the two
    packages' exceptions are different classes of the same name."""
    try:
        return "ok", fn(*args, **kwargs)
    except (ValueError, TypeError) as e:  # pydantic's errors included
        return "error", type(e).__name__


def _asdict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


# -- configs -------------------------------------------------------------

SLO_CASES = (
    {}, {"target_ttft_s": 0.5}, {"target_e2e_s": 2.0, "objective": 0.999},
    {"target_error_rate": 0.05, "windows": (300.0, 60.0)},
    {"objective": 1.0}, {"objective": 0.0}, {"target_ttft_s": 0.0},
    {"target_error_rate": 1.5}, {"windows": ()},
)


@pytest.mark.parametrize("kwargs", SLO_CASES)
def test_slo_config_validates_like_jax(kwargs):
    got = _outcome(lambda: _asdict(t_slo.SLOConfig(**kwargs)))
    want = _outcome(lambda: _asdict(j_slo.SLOConfig(**kwargs)))
    assert got == want


def test_deployment_and_autoscaling_configs_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        lo = int(rng.integers(0, 4))
        kw = dict(min_replicas=lo, max_replicas=lo + int(rng.integers(0, 5)),
                  target_ongoing_requests=float(rng.uniform(0.5, 8)))
        ja, ta = j_config.AutoscalingConfig(**kw), t_config.AutoscalingConfig(
            **kw)
        assert _asdict(ta) == _asdict(ja)
        for _ in range(5):
            ongoing = float(rng.uniform(0, 40))
            current = int(rng.integers(0, 6))
            assert (ta.desired_replicas(ongoing, current)
                    == ja.desired_replicas(ongoing, current))
        dkw = dict(num_replicas=int(rng.integers(1, 4)),
                   max_ongoing_requests=int(rng.integers(1, 64)))
        jd = j_config.DeploymentConfig(autoscaling_config=ja, **dkw)
        td = t_config.DeploymentConfig(autoscaling_config=ta, **dkw)
        assert _asdict(td) == _asdict(jd)
        assert td.initial_replicas() == jd.initial_replicas()


ENGINE_CASES = (
    {}, {"slots": 8, "chunk": 8, "block_size": 16, "max_len": 512},
    {"decode_kernel": "gather", "kv_dtype": "int8"},
    {"weight_dtype": "int8", "prefix_cache": False, "max_queued": 0},
    {"decode_kernel": "pallas"}, {"decode_kernel": "kernel"},
    {"kv_dtype": "fp8"}, {"weight_dtype": "int4"}, {"slots": 0},
    {"chunk": 0}, {"block_size": 0},
)


def _port_engine_kwargs(kwargs):
    """The JAX package's "pallas" route is the port's "kernel"; its
    "kernel" is no JAX route, so it maps to a name neither accepts."""
    name = {"pallas": "kernel", "kernel": "none"}.get(
        kwargs.get("decode_kernel"))
    return dict(kwargs, decode_kernel=name) if name else dict(kwargs)


def _jax_engine_dict(d):
    """The JAX package's config, read as the port's route names."""
    d = dict(d)
    if d.get("decode_kernel") == "pallas":
        d["decode_kernel"] = "kernel"
    return d


@pytest.mark.parametrize("kwargs", ENGINE_CASES)
def test_engine_config_names_the_ports_routes(kwargs):
    """`LLMEngineConfig` validates as the JAX package's does, with the
    port's route names; its engine kwargs are the port engine's."""
    got = _outcome(lambda: t_config.LLMEngineConfig(
        **_port_engine_kwargs(kwargs)).validate())
    want = _outcome(lambda: j_config.LLMEngineConfig(**kwargs).validate())
    assert got[0] == want[0]
    if got[0] == "ok":
        assert _asdict(got[1]) == _jax_engine_dict(_asdict(want[1]))
        assert got[1].engine_kwargs() == _jax_engine_dict(
            want[1].engine_kwargs())
    else:
        assert got[1] == want[1]


# -- schema ----------------------------------------------------------------

DOCS = (
    {"applications": [{"import_path": "m:app"}]},
    {"applications": [
        {"name": "a", "route_prefix": "/a", "import_path": "m.x:app",
         "args": {"k": 1},
         "deployments": [
             {"name": "D", "num_replicas": "auto",
              "ray_actor_options": {"num_cpus": 2, "num_tpus": 1,
                                    "resources": {"x": 1.0}}},
             {"name": "E", "max_ongoing_requests": 4,
              "autoscaling_config": {"min_replicas": 1, "max_replicas": 3,
                                     "target_ttft_s": 0.5}}]},
        {"name": "b", "route_prefix": "/b", "import_path": "n:app"}]},
    {"applications": [{"import_path": "no_colon"}]},
    {"applications": [{"name": "a", "import_path": "m:x"},
                      {"name": "a", "import_path": "m:y",
                       "route_prefix": "/y"}]},
    {"applications": [{"import_path": "m:x", "deployments": [
        {"name": "D", "num_replicas": -1}]}]},
    {"applications": [{"import_path": "m:x", "deployments": [
        {"name": "D", "autoscaling_config": {"min_replicas": 3,
                                             "max_replicas": 1}}]}]},
    {"applications": [{"import_path": "m:x", "bogus": 1}]},
)


def _dump_deploy(mod, doc):
    m = mod.ServeDeploySchema.model_validate(doc)
    out = m.model_dump()
    out["_overrides"] = [
        {k: _asdict(v) for k, v in d.override_kwargs().items()}
        for a in m.applications for d in a.deployments
    ]
    return out


def _as_port(doc):
    """The JAX package's accelerator keyword is the port's `num_gpus`."""
    return json.loads(json.dumps(doc).replace('"num_tpus"', '"num_gpus"'))


@pytest.mark.parametrize("doc", DOCS)
def test_schema_matches_jax(doc):
    """The deploy document validates (or is refused) alike, dumps alike,
    and expands into the same `.options()` overrides."""
    want = _outcome(_dump_deploy, j_schema, doc)
    if want[0] == "ok":
        want = ("ok", _as_port(want[1]))
    assert _outcome(_dump_deploy, t_schema, _as_port(doc)) == want


@pytest.mark.parametrize("kwargs", ENGINE_CASES)
def test_engine_schema_matches_jax(kwargs):
    def port():
        return _asdict(t_schema.LLMEngineSchema.model_validate(
            _port_engine_kwargs(kwargs)).to_config())

    def jax():
        return _jax_engine_dict(_asdict(
            j_schema.LLMEngineSchema.model_validate(kwargs).to_config()))

    got, want = _outcome(port), _outcome(jax)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert got == want


# -- autoscaling and SLOs --------------------------------------------------

def _metrics(rng, n):
    out = []
    for i in range(n):
        m = {"replica_id": f"r{i}", "ongoing": int(rng.integers(0, 20))}
        if rng.random() < 0.7:
            m["engine_queue_depth"] = float(rng.uniform(0, 40))
            m["user_stats"] = {
                "ttft_p90_s": float(rng.uniform(0, 2)),
                "shed_total": int(rng.integers(0, 3)),
                "rejected_total": int(rng.integers(0, 2)),
            }
        if rng.random() < 0.3:
            m["rejected"] = int(rng.integers(0, 4))
        out.append(m)
    return out


def test_autoscaling_decisions_match_jax():
    rng = np.random.default_rng(1)
    for trial in range(12):
        kw = dict(min_replicas=1, max_replicas=8,
                  target_queue_depth=(8.0 if trial % 3 else None),
                  target_ttft_s=(0.5 if trial % 2 else None),
                  hysteresis=float(rng.uniform(0, 0.3)))
        jp = j_autoscaling.AutoscalingPolicy(j_config.AutoscalingConfig(**kw))
        tp = t_autoscaling.AutoscalingPolicy(t_config.AutoscalingConfig(**kw))
        for _tick in range(6):
            ms = _metrics(rng, int(rng.integers(0, 5)))
            r = tp.pressure(ms)
            assert r == jp.pressure(ms)
            assert tp.refusal_forced == jp.refusal_forced
            for m in ms:
                assert (t_autoscaling.replica_depth(m)
                        == j_autoscaling.replica_depth(m))
            cur = int(rng.integers(1, 8))
            assert tp.desired_replicas(r, cur) == jp.desired_replicas(r, cur)


def test_slo_burn_rates_match_jax():
    rng = np.random.default_rng(2)
    cfg_kw = dict(target_ttft_s=0.25, target_e2e_s=1.0, objective=0.95,
                  windows=(5.0, 30.0))
    jt, tt = j_slo.BurnRateTracker(), t_slo.BurnRateTracker()
    jc, tc = j_slo.SLOConfig(**cfg_kw), t_slo.SLOConfig(**cfg_kw)
    counters = {f"r{i}": j_slo.empty_counters() for i in range(3)}
    assert t_slo.empty_counters() == j_slo.empty_counters()
    now = 1000.0
    for _step in range(40):
        rid = f"r{int(rng.integers(0, 3))}"
        c = counters[rid]
        if rng.random() < 0.1:
            c = counters[rid] = j_slo.empty_counters()  # replica restart
        for _ in range(int(rng.integers(0, 6))):
            ttft, e2e = float(rng.exponential(0.2)), float(
                rng.exponential(0.8))
            assert t_slo.bucket_index(ttft) == j_slo.bucket_index(ttft)
            c["n"] += 1
            c["errors"] += int(rng.random() < 0.05)
            c["ttft"][j_slo.bucket_index(ttft)] += 1
            c["e2e"][j_slo.bucket_index(e2e)] += 1
        snap = json.loads(json.dumps(c))
        jt.fold(rid, snap)
        tt.fold(rid, snap)
        now += float(rng.uniform(0.5, 3.0))
        jt.snapshot(now)
        tt.snapshot(now)
        assert tt.burn_rates(tc, now) == jt.burn_rates(jc, now)
    assert t_slo.status_for(tt, tc).keys() == j_slo.status_for(jt, jc).keys()


# -- router ----------------------------------------------------------------

def _picks(router_mod, seed, depths, max_ongoing, n, affinity=""):
    r = router_mod.Router("dep", "app")
    table = {"version": 1, "incarnation": "i0",
             "replicas": {rid: (None, max_ongoing) for rid in depths},
             "depths": depths, "max_queued": -1}
    r._install_table(table)
    random.seed(seed)
    out = []
    for i in range(n):
        info = r._try_pick(affinity_key=affinity if i % 3 == 0 else "")
        out.append(None if info is None else info.replica_id)
    return out


def test_router_pow2_pick_matches_jax():
    """The pow-2 choice under a seeded RNG, with controller-reported
    depths and per-replica caps, picks the same replicas in the same
    order (affinity hashing included); saturation returns None alike."""
    rng = np.random.default_rng(3)
    for seed in range(6):
        depths = {f"rep{i}": float(rng.uniform(0, 10))
                  for i in range(int(rng.integers(1, 6)))}
        cap = int(rng.integers(1, 6))
        args = (seed, depths, cap, 24, "model-%d" % seed)
        assert _picks(t_router, *args) == _picks(j_router, *args)


# -- batching ----------------------------------------------------------------

def _batched_run(batching_mod, n, max_batch, bucket=None):
    seen = []

    class Svc:
        @batching_mod.batch(max_batch_size=max_batch,
                            batch_wait_timeout_s=0.5,
                            bucket_fill_timeout_s=bucket)
        async def handle(self, items):
            seen.append(list(items))
            return [x * 10 for x in items]

    async def main():
        svc = Svc()
        return await asyncio.wait_for(
            asyncio.gather(*[svc.handle(i) for i in range(n)]), timeout=30)

    return asyncio.run(main()), seen


@pytest.mark.parametrize("n,max_batch,bucket", [(10, 4, None), (7, 8, None),
                                                (9, 16, 0.01)])
def test_batch_grouping_matches_jax(n, max_batch, bucket):
    assert _batched_run(t_batching, n, max_batch, bucket) == _batched_run(
        j_batching, n, max_batch, bucket)


def test_batch_queue_cap_rejects_like_jax():
    """A bounded batch queue refuses an overflow submit while a batch
    is executing, with the same type and retry hint."""
    def run(mod, exc_name):
        gate = None

        class Svc:
            @mod.batch(max_batch_size=1, batch_wait_timeout_s=0.01,
                       max_queued_requests=1)
            async def handle(self, items):
                await gate.wait()
                return items

        async def main():
            nonlocal gate
            gate = asyncio.Event()
            svc = Svc()
            first = asyncio.ensure_future(svc.handle(1))
            await asyncio.sleep(0.05)   # the first batch is executing
            second = asyncio.ensure_future(svc.handle(2))
            await asyncio.sleep(0.01)   # ... and the second queues
            try:
                await asyncio.wait_for(svc.handle(3), timeout=5)
                refused = None
            except (BackPressureError, JaxBackPressureError) as e:
                refused = (type(e).__name__, e.retry_after_s)
            gate.set()
            done = await asyncio.wait_for(asyncio.gather(first, second), 10)
            return refused, done

        return asyncio.run(main())

    got = run(t_batching, "BackPressureError")
    assert got == run(j_batching, "BackPressureError")
    assert got[0][0] == BackPressureError.__name__


# -- a deployment through handle and HTTP ------------------------------------

@pytest.fixture(scope="module")
def serve_instance():
    rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    yield serve
    serve.shutdown()
    rt.shutdown()


@serve.deployment(num_replicas=2)
class _Echo:
    def __init__(self, scale):
        self.scale = scale

    def mul(self, x):
        return x * self.scale

    async def __call__(self, request):
        body = request.json()
        return {"out": [v * self.scale for v in body["values"]]}


def test_deployment_through_handle_and_http(serve_instance):
    h = serve.run(_Echo.bind(3), name="echo", route_prefix="/echo",
                  timeout_s=120)
    try:
        got = [h.mul.remote(i).result(timeout_s=60) for i in range(6)]
        assert got == [3 * i for i in range(6)]
        host, port = serve.http_address()
        req = urllib.request.Request(
            f"http://{host}:{port}/echo",
            data=json.dumps({"values": [1, 2, 5]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            assert json.loads(resp.read()) == {"out": [3, 6, 15]}
        assert serve.status()["echo"]["_Echo"]["running"] == 2
    finally:
        serve.delete("echo")

"""Port parity: `ray_tpu_torch.parallel.pipeline` (the GPipe schedule over
a `pp` process group) and `parallel/pipeline_dag.py` (1F1B across stage
actors over the compiled graphs' channels) against the JAX package's.

Inputs and stage params come from seeded numpy (RT008) through
`jax.random` on the JAX side, copied as numpy.  `pipeline_apply` runs on
4 gloo ranks (`test_torch_parallel.spawn`) against JAX's on 4 CPU
devices: values at 1e-5, gradients at the reference's own 1e-4, and the
same answer at 2 and 8 microbatches.  The schedule functions equal the
reference's over a grid of stages and microbatches.  `CompiledPipeline`
runs on a port cluster against JAX's serial loss and gradients at rtol
1e-5 (the reference test's limits), and its teardown returns the
channels' arena.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu.parallel import pipeline as jpipe  # noqa: E402
from ray_tpu.parallel import pipeline_dag as jpd  # noqa: E402
from ray_tpu_torch.parallel import pipeline_dag as tpd  # noqa: E402

from test_torch_parallel import spawn  # noqa: E402


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _make(S=4, D=16, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    return {"w": np.asarray(jax.random.normal(ks[0], (S, D, D)) * 0.3),
            "b": np.asarray(jax.random.normal(ks[1], (S, D)) * 0.1)}


def _x(B, D, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (B, D)))


def _per_stage(full, S):
    return [{"w": full["w"][s], "b": full["b"][s]} for s in range(S)]


def _serial_loss(stage_params, x):
    h = x
    for p in stage_params:
        h = _jstage(p, h)
    return jnp.mean(h ** 2)


# ----------------------------------------------------------------------
# the schedule model (no cluster)
# ----------------------------------------------------------------------
GRID = [(S, M) for S in range(1, 7) for M in range(1, 10)]


@pytest.mark.parametrize("S,M", GRID)
def test_schedule_functions_match_jax(S, M):
    for s in range(S):
        assert tpd.one_f1b_schedule(s, S, M) == jpd.one_f1b_schedule(s, S, M)
        assert tpd.schedule_phases(s, S, M) == jpd.schedule_phases(s, S, M)
    assert tpd.bubble_fraction(S, M) == jpd.bubble_fraction(S, M)
    assert tpd.schedule_makespan_units(S, M) == \
        jpd.schedule_makespan_units(S, M) == 2 * (M + S - 1)


# ----------------------------------------------------------------------
# pipeline_apply: 4 gloo ranks against JAX's on 4 CPU devices
# ----------------------------------------------------------------------
_PP_TASK = """
import numpy as np
import torch
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel.pipeline import pipeline_apply

def stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])

def run(rank, world, inp):
    mesh = MeshSpec(pp=world).build(device_type="cpu")
    out = {}
    p = {k: torch.from_numpy(inp[k]) for k in ("w", "b")}
    x = torch.from_numpy(inp["x"])
    with torch.no_grad():
        out["out4"] = pipeline_apply(stage, p, x, mesh, 4).numpy()
        for m in (2, 8):
            out[f"inv{m}"] = pipeline_apply(stage, p, x, mesh, m).numpy()
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    loss = (pipeline_apply(stage, p, xg, mesh, 2) ** 2).mean()
    gw, gb, gx = torch.autograd.grad(loss, (p["w"], p["b"], xg))
    out.update(loss=loss.detach().numpy(), gw=gw.numpy(), gb=gb.numpy(),
               gx=gx.numpy())
    bad = {k: v[:3] for k, v in p.items()}
    try:
        pipeline_apply(stage, bad, x, mesh, 2)
        out["mismatch"] = np.array("no error")
    except ValueError as e:
        out["mismatch"] = np.array(str(e))
    return out
"""


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    S, D, B = 4, 16, 8
    full = _make(S, D)
    x = _x(B, D, 1)
    mesh = Mesh(np.array(jax.devices("cpu")[:S]).reshape(S), ("pp",))
    sharded = jax.device_put(full, jpipe.stage_sharding(mesh))

    def loss_pp(p, x):
        return jnp.mean(jpipe.pipeline_apply(_jstage, p, x, mesh, 2) ** 2)

    with mesh:
        out4 = jax.jit(lambda p, x: jpipe.pipeline_apply(
            _jstage, p, x, mesh, 4))(sharded, x)
        loss, (gp, gx) = jax.jit(jax.value_and_grad(
            loss_pp, argnums=(0, 1)))(sharded, x)
    want = {"out4": np.asarray(out4), "loss": float(loss),
            "gw": np.asarray(gp["w"]), "gb": np.asarray(gp["b"]),
            "gx": np.asarray(gx)}
    # serial application, as the reference's own tests hold it
    serial = jax.grad(lambda ps, x: _serial_loss(ps, x), argnums=(0, 1))(
        _per_stage(full, S), x)
    want["serial_gw"] = np.stack([g["w"] for g in serial[0]])
    want["serial_gx"] = np.asarray(serial[1])
    outs = spawn(_PP_TASK, S, {**full, "x": x},
                 tmp_path_factory.mktemp("pp"))
    return outs, want


def test_pipeline_apply_values_match_jax(pp_run):
    outs, want = pp_run
    for got in outs:
        np.testing.assert_allclose(got["out4"], want["out4"], rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_apply_grads_match_jax_not_s_times(pp_run):
    """The closing sum over `pp` passes each rank its own output
    gradient: every stage's gradient is the serial one, not S times it."""
    outs, want = pp_run
    for got in outs:
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5)
        for k in ("gw", "gb", "gx"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["gw"], want["serial_gw"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["gx"], want["serial_gx"], rtol=1e-4,
                                   atol=1e-5)


def test_pipeline_apply_microbatch_invariance(pp_run):
    outs, want = pp_run
    for got in outs:
        np.testing.assert_allclose(got["inv2"], got["inv8"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["inv2"], want["out4"], rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_apply_rejects_a_stage_count_off_the_mesh(pp_run):
    outs, _ = pp_run
    assert all("must equal the mesh's pp size 4" in str(o["mismatch"])
               for o in outs)


# ----------------------------------------------------------------------
# CompiledPipeline on a port cluster
# ----------------------------------------------------------------------
def _fns():
    """The stage and loss functions, made here so that they travel to
    the stage actors by value."""

    def stage_fn(params, x):
        return torch.tanh(x @ params["w"] + params["b"])

    def loss_fn(y):
        return (y ** 2).mean()

    return stage_fn, loss_fn


def _torch_stages(full, S):
    return [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
            for p in _per_stage(full, S)]


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    yield
    rt.shutdown()


def test_1f1b_matches_serial_loss_and_grads(cluster):
    S, D, B, M = 4, 16, 8, 4
    full = _make(S, D)
    x = _x(B, D, 1)
    ref_loss, ref_grads = jax.value_and_grad(_serial_loss)(
        _per_stage(full, S), x)
    stage_fn, loss_fn = _fns()
    pipe = tpd.compile_pipeline(stage_fn, _torch_stages(full, S), loss_fn, M)
    try:
        for feed in (torch.from_numpy(x), x):  # a tensor, then an array
            out = pipe.execute(feed).get(timeout=180)
            np.testing.assert_allclose(out["loss"], float(ref_loss),
                                       rtol=1e-5)
            for s in range(S):
                for k in ("w", "b"):
                    g = out["grads"][s][k]
                    assert isinstance(g, torch.Tensor) and not g.is_cuda
                    np.testing.assert_allclose(
                        g.numpy(), np.asarray(ref_grads[s][k]), rtol=1e-5,
                        atol=1e-6)
    finally:
        pipe.teardown()


def test_1f1b_microbatch_count_invariance(cluster):
    S, D, B = 2, 8, 8
    full = _make(S, D, seed=5)
    x = _x(B, D, 4)
    stage_fn, loss_fn = _fns()
    results = {}
    for M in (2, 8):
        pipe = tpd.compile_pipeline(stage_fn, _torch_stages(full, S),
                                    loss_fn, M)
        try:
            results[M] = pipe.execute(x).get(timeout=180)
        finally:
            pipe.teardown()
    np.testing.assert_allclose(results[2]["loss"], results[8]["loss"],
                               rtol=1e-5)
    for s in range(S):
        for k in ("w", "b"):
            np.testing.assert_allclose(results[2]["grads"][s][k].numpy(),
                                       results[8]["grads"][s][k].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_pipeline_teardown_frees_channel_arena(cluster):
    from ray_tpu_torch.core.runtime import get_runtime

    S, D, B, M = 2, 8, 4, 2
    full = _make(S, D, seed=7)
    x = np.ones((B, D), np.float32)
    stage_fn, loss_fn = _fns()
    store = get_runtime().store
    used_before = store.used
    for _ in range(2):
        pipe = tpd.compile_pipeline(stage_fn, _torch_stages(full, S),
                                    loss_fn, M)
        try:
            pipe.execute(x).get(timeout=120)
        finally:
            pipe.teardown()
    assert store.used <= used_before + 256 * 1024, (used_before, store.used)

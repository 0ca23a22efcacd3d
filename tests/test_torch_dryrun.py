"""Port parity: the multichip dry run (`ray_tpu_torch/dryrun.py`) against
the reference's entry points (`__graft_entry__.py`).

`_factor_mesh` is held to the reference's for 1-16 devices.
`dryrun_multichip(4)` (GPT-2 over tp 2 x sp 2 with ring attention, the
pp sub-mesh's `pipeline_apply`, Mixtral's step over ep 4 and
`dryrun_multislice(2, 2)`) and `dryrun_multichip(8)` (fsdp 2 x tp 2 x
sp 2 and `dryrun_multislice(2, 4)`) run on 4 and 8 gloo ranks
(`test_torch_parallel.spawn`) with the reference's own draws: the
ranks replace the dry run's input builders (`gpt2_inputs`,
`pp_inputs`, `mixtral_inputs`) with the JAX package's `jax.random`
params and tokens, carried across by `models/bridge.py`.  The JAX side
runs the same steps jitted over the same meshes on its 8 CPU devices;
`dryrun_multislice`'s loss is the reference function's own float.
Both sides compute in f32 (the reference's configs with `dtype` f32,
its `GPT2Config` patched for the call), so the losses hold at rtol
1e-5.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import mixtral as jmx  # noqa: E402
from ray_tpu.parallel import MeshSpec as JMeshSpec  # noqa: E402
from ray_tpu.parallel import data_sharding, tree_shardings  # noqa: E402
from ray_tpu.parallel.pipeline import pipeline_apply  # noqa: E402
from ray_tpu.parallel.pipeline import stage_sharding  # noqa: E402
from ray_tpu_torch import dryrun  # noqa: E402
from test_torch_parallel import spawn  # noqa: E402
from test_torch_sharded_train import _flat  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import __graft_entry__ as graft  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# ----------------------------------------------------------------------
# the ranks' task: the dry run on the reference's draws
# ----------------------------------------------------------------------
_TASK = """
import numpy as np
import torch

from ray_tpu_torch import dryrun
from ray_tpu_torch.models.bridge import params_from_numpy


def tree(inp, prefix):
    out = {}
    for key, value in inp.items():
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
    return params_from_numpy(out, "cpu")


def run(rank, world, inp):
    t = lambda name: torch.from_numpy(inp[name])  # noqa: E731
    dryrun.gpt2_inputs = lambda cfg, batch, seq, seed, device: (
        tree(inp, "gpt2"), t(f"tokens_{seed}_{batch}_{seq}"))
    dryrun.pp_inputs = lambda S, device: ({"w": t("pp_w")}, t("pp_x"))
    dryrun.mixtral_inputs = lambda cfg, ep, device: (
        tree(inp, "mixtral"), t("mixtral_tokens"))
    got = dryrun.dryrun_multichip(world, device="cpu", dtype=torch.float32)
    out = {k: np.asarray(v) for k, v in got.items()
           if k not in ("mesh", "pp_out") and v is not None}
    out["mesh"] = np.asarray([got["mesh"][a] for a in
                              ("dp", "fsdp", "tp", "sp")])
    if got["pp_out"] is not None:
        out["pp_out"] = got["pp_out"].numpy()
    return out
"""


_GPT2Config = jgpt2.GPT2Config


def _f32_gpt2(**kw):
    return _GPT2Config(**{"dtype": jnp.float32, **kw})


def _jax_multichip_gpt2(axes: dict, params, tokens) -> dict:
    """The reference's multichip GPT-2 step (`__graft_entry__.py:53`) in
    f32 on the same draws."""
    n = int(np.prod(list(axes.values())))
    mesh = JMeshSpec(**axes).build(jax.devices()[:n])
    cfg = _f32_gpt2(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                    n_head=max(4, axes["tp"]),
                    attention="ring" if axes["sp"] > 1 else "dense",
                    remat=True)
    params = jax.device_put(params, tree_shardings(
        mesh, jgpt2.logical_axes(cfg)))
    opt = jgpt2.default_optimizer(total_steps=10)
    tokens = jax.device_put(tokens, data_sharding(mesh))
    with mesh:
        _, _, m = jax.jit(jgpt2.make_train_step(cfg, opt, mesh))(
            params, opt.init(params), tokens)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _jax_pipeline(w, x):
    from jax.sharding import Mesh

    S = w.shape[0]
    mesh = Mesh(np.array(jax.devices()[:S]), ("pp",))
    p = jax.device_put({"w": w}, stage_sharding(mesh))
    with mesh:
        return np.asarray(pipeline_apply(
            lambda p, xb: jnp.tanh(xb @ p["w"]), p, x, mesh, 4))


def _jax_mixtral(params, tokens) -> float:
    from jax.sharding import Mesh

    ep = 4
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    cfg = jmx.MixtralConfig(
        vocab_size=128, max_seq_len=32, dim=32, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=48, num_experts=ep, top_k=1,
        dtype=jnp.float32)
    opt = optax.adamw(1e-3)
    with mesh:
        _, _, m = jax.jit(jmx.make_train_step(cfg, opt, mesh))(
            params, opt.init(params), tokens)
    return float(m["loss"])


def _reference_multislice(monkeypatch, n_slices, per_slice) -> float:
    """`__graft_entry__.dryrun_multislice`'s own float, its GPT-2 in f32."""
    with monkeypatch.context() as m:
        m.setattr(jgpt2, "GPT2Config", _f32_gpt2)
        return graft.dryrun_multislice(n_slices, per_slice)


def _draws(n: int) -> dict:
    """The reference's draws for `dryrun_multichip(n)`, as numpy."""
    axes = graft._factor_mesh(n)
    fsdp = max(1, n // 2 // 2)
    out = {}
    for seed, batch, seq in ((1, axes["dp"] * axes["fsdp"] * 2,
                              32 * axes["sp"]),
                             (2, 2 * 2 * fsdp, 32)):
        out[f"tokens_{seed}_{batch}_{seq}"] = np.asarray(jax.random.randint(
            jax.random.PRNGKey(seed), (batch, seq + 1), 0, 256,
            dtype=jnp.int32))
    out["pp_w"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(3), (4, 16, 16)) * 0.3)
    out["pp_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                               (8, 16)))
    out["mixtral_tokens"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(6), (8, 17), 0, 128, dtype=jnp.int32))
    return out


@pytest.fixture(scope="module")
def weights():
    gcfg = _f32_gpt2(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                     n_head=4)
    mcfg = jmx.MixtralConfig(
        vocab_size=128, max_seq_len=32, dim=32, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=48, num_experts=4, top_k=1)
    return {"gpt2": jgpt2.init_params(gcfg, jax.random.PRNGKey(0)),
            "mixtral": jmx.init_params(mcfg, jax.random.PRNGKey(5))}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """Each world's ranks' readings and the JAX side's."""
    out = {}
    for n in (4, 8):
        draws = _draws(n)
        inputs = {**draws,
                  **_flat(jax.tree.map(np.asarray, weights["gpt2"]), "gpt2"),
                  **_flat(jax.tree.map(np.asarray, weights["mixtral"]),
                          "mixtral")}
        axes = graft._factor_mesh(n)
        tokens = draws[f"tokens_1_{axes['dp'] * axes['fsdp'] * 2}_"
                       f"{32 * axes['sp']}"]
        out[n] = {
            "ranks": spawn(_TASK, n, inputs,
                           tmp_path_factory.mktemp(f"dryrun{n}"),
                           timeout=300.0),
            "gpt2": _jax_multichip_gpt2(axes, weights["gpt2"],
                                        jnp.asarray(tokens)),
        }
    draws = _draws(4)
    out["pp_out"] = _jax_pipeline(jnp.asarray(draws["pp_w"]),
                                  jnp.asarray(draws["pp_x"]))
    out["mixtral_loss"] = _jax_mixtral(weights["mixtral"],
                                       jnp.asarray(draws["mixtral_tokens"]))
    return out


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_matches_reference(n):
    """The same split of n devices over (dp, fsdp, tp, sp)."""
    assert dryrun._factor_mesh(n) == graft._factor_mesh(n)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_gpt2_step_matches_reference(runs, n):
    """`dryrun_multichip(n)`'s GPT-2 step on `_factor_mesh(n)` (tp 2 x sp 2
    at 4, fsdp 2 x tp 2 x sp 2 at 8, ring attention over sp): the loss
    and the pre-clip gradient norm of the reference's step on the same
    draws, on every rank."""
    want = runs[n]["gpt2"]
    axes = graft._factor_mesh(n)
    for out in runs[n]["ranks"]:
        assert list(out["mesh"]) == [axes[a] for a in
                                     ("dp", "fsdp", "tp", "sp")]
        np.testing.assert_allclose(out["gpt2_loss"], want["loss"], **TOL)
        np.testing.assert_allclose(out["gpt2_grad_norm"],
                                   want["grad_norm"], **TOL)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_sub_meshes_match_reference(runs, n):
    """The pp sub-mesh's `pipeline_apply` (4 stages) on ranks 0-3 and
    Mixtral's step over ep 4 equal the reference's; the ranks outside
    the sub-meshes (4-7 at 8) report none."""
    for r, out in enumerate(runs[n]["ranks"]):
        if r >= 4:
            assert "pp_out" not in out and "mixtral_loss" not in out
            continue
        np.testing.assert_allclose(out["pp_out"], runs["pp_out"], **TOL)
        np.testing.assert_allclose(out["mixtral_loss"],
                                   runs["mixtral_loss"], **TOL)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multislice_matches_reference(runs, monkeypatch, n):
    """`dryrun_multislice(2, n // 2)` on the hybrid mesh of two slices:
    the loss the reference's function returns, on every rank."""
    want = _reference_multislice(monkeypatch, 2, n // 2)
    for out in runs[n]["ranks"]:
        np.testing.assert_allclose(out["multislice_loss"], want, **TOL)

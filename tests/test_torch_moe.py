"""Port parity: `ray_tpu_torch.parallel.moe` against the JAX package's
`ray_tpu.parallel.moe` on the CPU.

Params cross from JAX through the weight bridge and inputs come from
seeded numpy (RT008), so both sides route the same tokens.  `lax.top_k`
and `torch.topk` may break exact ties differently, so each case first
holds the routing indices equal, then the outputs, the load-balance
loss and the gradients at f32 rtol / atol 1e-5.  Expert parallelism
runs over 4 gloo ranks (`test_torch_parallel.spawn`) against JAX's `ep`
on 4 of its CPU devices at 2e-4, the JAX test's own limit.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from ray_tpu.parallel import moe as jmoe  # noqa: E402
from ray_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from ray_tpu_torch.parallel import moe as tmoe  # noqa: E402

from test_torch_parallel import spawn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
EP_TOL = dict(rtol=2e-4, atol=2e-4)

# (dim, hidden, experts, top_k, capacity factor): a capacity of 1.0 drops
# pairs (the slot [0, 0] scatter of zeros), 4.0 drops none
CASES = [(32, 64, 4, 2, 1.25), (32, 64, 4, 2, 1.0), (16, 32, 4, 1, 4.0),
         (24, 40, 8, 2, 0.5)]


def _cfgs(case):
    dim, hidden, E, k, cf = case
    kw = dict(dim=dim, hidden=hidden, num_experts=E, top_k=k,
              capacity_factor=cf)
    return (jmoe.MoEConfig(**kw, dtype=jnp.float32),
            tmoe.MoEConfig(**kw, dtype=torch.float32))


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jp, jax.tree.map(np.asarray, jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_gelu_is_jaxs_tanh_form():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the exact form, torch's default, is not what the reference computes
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("tokens", [1, 7, 32, 100, 1024, 4096])
@pytest.mark.parametrize("cf,k,E", [(1.25, 2, 8), (1.0, 1, 4), (0.3, 2, 8),
                                    (16.0, 2, 4), (1.1, 3, 7)])
def test_capacity_matches_jax(tokens, cf, k, E):
    kw = dict(dim=8, hidden=8, num_experts=E, top_k=k, capacity_factor=cf)
    assert tmoe._capacity(tokens, tmoe.MoEConfig(**kw), 1) == \
        jmoe._capacity(tokens, jmoe.MoEConfig(**kw), 1)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_local_forward_aux_and_grads_match_jax(case):
    jcfg, tcfg = _cfgs(case)
    jp, pn = _params(jcfg)
    x = _x((2, 16, jcfg.dim), seed=1)
    # routing first: the same experts for every (token, k)
    x2d = x.reshape(-1, jcfg.dim)
    _, ji, _ = jmoe._route(jcfg, jp["router"], jnp.asarray(x2d))
    tp = params_from_numpy(pn, device="cpu")
    _, ti, _ = tmoe._route(tcfg, tp["router"], torch.from_numpy(x2d))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    def jloss(p):
        o, a = jmoe.moe_forward(jcfg, p, jnp.asarray(x))
        return jnp.mean(o ** 2) + 0.01 * a["load_balance_loss"], (o, a)

    (jl, (jo, ja)), jg = jax.jit(jax.value_and_grad(jloss,
                                                   has_aux=True))(jp)
    names = sorted(tp)
    for n in names:
        tp[n].requires_grad_(True)
    to, ta = tmoe.moe_forward(tcfg, tp, torch.from_numpy(x))
    tl = (to ** 2).mean() + 0.01 * ta["load_balance_loss"]
    tg = torch.autograd.grad(tl, [tp[n] for n in names])
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta["load_balance_loss"].detach()),
                               float(ja["load_balance_loss"]), **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for n, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), **TOL,
                                   err_msg=n)


def test_dispatch_drops_into_slot_zero_like_jax():
    """Pairs past the capacity add zeros into slot [0, 0]: the slots,
    positions and keep mask equal the reference's."""
    jcfg, tcfg = _cfgs((8, 8, 2, 2, 0.5))
    x2d = _x((12, 8), seed=3)
    top_i = np.random.default_rng(4).integers(0, 2, (12, 2))
    top_i[:, 1] = 1 - top_i[:, 0]
    top_p = np.full((12, 2), 0.5, np.float32)
    cap = jmoe._capacity(12, jcfg, 1)
    js, jpos, jkeep = jmoe._dispatch(jcfg, jnp.asarray(x2d),
                                     jnp.asarray(top_p), jnp.asarray(top_i),
                                     cap)
    ts, tpos, tkeep = tmoe._dispatch(tcfg, torch.from_numpy(x2d),
                                     torch.from_numpy(top_p),
                                     torch.from_numpy(top_i), cap)
    assert not np.asarray(jkeep).all()  # some pairs drop
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_logical_axes_match_jax():
    jcfg, tcfg = _cfgs(CASES[0])
    assert tmoe.moe_logical_axes(tcfg) == jmoe.moe_logical_axes(jcfg)
    assert dataclasses.asdict(tmoe.MoEConfig(dim=4, hidden=8)).keys() == \
        dataclasses.asdict(jmoe.MoEConfig(dim=4, hidden=8)).keys()


# ----------------------------------------------------------------------
# expert parallelism: 4 gloo ranks against JAX's ep on 4 CPU devices
# ----------------------------------------------------------------------
_EP_TASK = """
import numpy as np
import torch
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel import moe

def run(rank, world, inp):
    mesh = MeshSpec(ep=world).build(device_type="cpu")
    out = {}
    for c in range(int(inp["n_cases"])):
        dim, hidden, E, k, cf = (float(v) for v in inp[f"case{c}"])
        cfg = moe.MoEConfig(dim=int(dim), hidden=int(hidden),
                            num_experts=int(E), top_k=int(k),
                            capacity_factor=cf, dtype=torch.float32)
        p = {n: torch.from_numpy(inp[f"{n}{c}"]).requires_grad_(True)
             for n in ("router", "w_in", "w_out")}
        x = torch.from_numpy(inp[f"x{c}"]).requires_grad_(True)
        o, a = moe.moe_forward(cfg, p, x, mesh)
        loss = (o ** 2).mean() + 0.01 * a["load_balance_loss"]
        gs = torch.autograd.grad(loss, [p["router"], p["w_in"], p["w_out"],
                                        x])
        out[f"out{c}"] = o.detach().numpy()
        out[f"aux{c}"] = a["load_balance_loss"].detach().numpy()
        for n, g in zip(("router", "w_in", "w_out", "x"), gs):
            out[f"g_{n}{c}"] = g.numpy()
    out["transports"] = np.array(sum(
        v for (op, _, _), v in collectives.TRANSPORTS.items()
        if op == "all_to_all"))
    return out
"""

EP_CASES = [(16, 32, 4, 1, 4.0), (16, 24, 8, 2, 1.0)]


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    inputs = {"n_cases": np.array(len(EP_CASES))}
    want = []
    mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(4), ("ep",))
    for c, case in enumerate(EP_CASES):
        jcfg, _ = _cfgs(case)
        jp, pn = _params(jcfg, seed=c)
        x = _x((4, 8, jcfg.dim), seed=10 + c)
        inputs[f"case{c}"] = np.array(case, np.float64)
        inputs[f"x{c}"] = x
        for n, v in pn.items():
            inputs[f"{n}{c}"] = v

        def jloss(p, x):
            o, a = jmoe.moe_forward(jcfg, p, x, mesh)
            return jnp.mean(o ** 2) + 0.01 * a["load_balance_loss"], (o, a)

        (_, (jo, ja)), (jg, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
        # the reference's own oracle: the local path on each batch shard
        shards = [np.asarray(jmoe.moe_forward(jcfg, jp, jnp.asarray(
            x[i:i + 1]))[0]) for i in range(4)]
        want.append({"out": np.asarray(jo), "aux": float(
            ja["load_balance_loss"]), "oracle": np.concatenate(shards),
            **{f"g_{n}": np.asarray(jg[n]) for n in jg},
            "g_x": np.asarray(jgx)})
    outs = spawn(_EP_TASK, 4, inputs, tmp_path_factory.mktemp("moe_ep"))
    return outs, want


@pytest.mark.parametrize("c", range(len(EP_CASES)))
def test_ep_over_four_ranks_matches_jax_ep(ep_run, c):
    outs, want = ep_run
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got[f"out{c}"], want[c]["out"], **EP_TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"out{c}"], want[c]["oracle"],
                                   **EP_TOL)
        np.testing.assert_allclose(float(got[f"aux{c}"]), want[c]["aux"],
                                   **EP_TOL)
        for n in ("router", "w_in", "w_out", "x"):
            np.testing.assert_allclose(got[f"g_{n}{c}"], want[c][f"g_{n}"],
                                       **EP_TOL, err_msg=f"{n} rank {r}")
        # there and back, forward and backward, every case
        assert int(got["transports"]) == 4 * len(EP_CASES)


def test_ep_rejects_experts_that_do_not_divide(tmp_path):
    task = """
import torch
from ray_tpu_torch.parallel import MeshSpec, moe

def run(rank, world, inp):
    mesh = MeshSpec(ep=world).build(device_type="cpu")
    cfg = moe.MoEConfig(dim=4, hidden=4, num_experts=6,
                        dtype=torch.float32)
    p = moe.init_moe(cfg, 0, device="cpu")
    try:
        moe.moe_forward(cfg, p, torch.zeros(4, 2, 4), mesh)
    except ValueError as e:
        return {"msg": str(e)}
    return {"msg": "no error"}
"""
    outs = spawn(task, 4, {}, tmp_path)
    assert all("must divide" in str(o["msg"]) for o in outs)

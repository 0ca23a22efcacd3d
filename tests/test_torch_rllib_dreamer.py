"""The port's DreamerV3 (`ray_tpu_torch.rllib.algorithms.dreamer`)
against the JAX package's on the CPU, and the reference's cases for it
on the port with the learner on the CPU.

Parity, on the same seeded numpy inputs and params bridged from JAX's
`init_params` (the inits cannot match: JAX splits one key ten ways, the
port draws from one `torch.Generator`), with JAX's own draws injected:
every categorical draw is `argmax(logits + Gumbel noise)` in both
packages, so the tests compute the noise from JAX's key splits (one
`gumbel(keys[t])` a posterior step; `ka, kz = split(key)` an imagined
step) and hand it to the port.  Held at f32 rtol / atol 1e-5:
`symlog` / `symexp`, `lambda_returns` (and against the reference test's
brute force), `_sample_categorical` (the draw and its straight-through
gradient), the transposed convolution (k 3 / s 2 and k 4 / s 2, at 10 x
5 and 84 x 84), `rssm_observe`, `world_model_loss` (value, metrics and
every gradient leaf) and `imagine`, in vector and pixel mode; one
`_wm_update` and one `_ac_update` against the reference's jitted ones
(params, whose elements with a rounding-level gradient may take Adam's
opposite whole-lr step and are held within 2 lr; Adam's moments; the
metrics; `ret_std`); `_DreamerPolicy` (numpy, a copy) exactly.

The algorithm pairs are built over a local stand-in for the runner
group (`_JLocal` / `_TLocal`), so no runtime boots for them.  The
reference's cases (the world model learns a dynamic, CartPole) and a
checkpoint round trip run on one port cluster; its pixel case is in
`test_torch_rllib_dreamer_pixels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import dreamer as jd
from ray_tpu_torch.models.bridge import params_from_numpy, tree_leaves
from ray_tpu_torch.models.bridge import tree_map
from ray_tpu_torch.rllib.algorithms import dreamer as td
from test_torch_rllib import _np
from test_torch_rllib_replay import _JLocal, _TLocal
from test_torch_rllib_vtrace import _grad_rel
from test_torch_waits import within

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
# a gradient below this share of its leaf's largest is at rounding level:
# Adam's first step there may go either way
NOISE = 1e-6


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    yield
    rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The learners' ops are tiny: on a shared CPU, PyTorch's intra-op
    threads cost many times a single thread's time for them, and the
    parallel test run's other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _config(mod, pixel: bool):
    """A tiny config (deter 16, 3 x 4 categoricals, widths 16, horizon
    5, segments 4 x 6); free bits 0 so that both KL terms take their
    gradient."""
    c = mod.DreamerConfig()
    c.environment("Catch-v0" if pixel else "CartPole-v1")
    c.debugging(seed=0)
    c.deter_size, c.stoch_groups, c.stoch_classes = 16, 3, 4
    c.embed_hidden = c.head_hidden = (16,)
    c.conv_filters = ((4, 3, 2), (8, 3, 2))
    c.horizon = 5
    c.batch_length, c.batch_segments = 6, 4
    c.free_bits = 0.0
    return c


def _models(pixel: bool):
    if pixel:
        shape = (10, 5, 2)
        return (jd.DreamerModel(_config(jd, True), 100, 3, obs_shape=shape),
                td.DreamerModel(_config(td, True), 100, 3, obs_shape=shape))
    return (jd.DreamerModel(_config(jd, False), 4, 3),
            td.DreamerModel(_config(td, False), 4, 3))


def _port(tree, grad=False):
    out = params_from_numpy(_np(tree), "cpu")
    return tree_map(lambda t: t.requires_grad_(True), out) if grad else out


def _segments(model, L=6, B=4, seed=0):
    rng = np.random.default_rng(seed)
    if model.pixel:
        obs = (rng.random((L, B, *model.obs_shape)) < 0.2).astype(np.float32)
    else:
        obs = rng.normal(size=(L, B, model.obs_dim)).astype(np.float32) * 2
    return {"obs": obs,
            "prev_actions": rng.integers(0, model.num_actions,
                                         (L, B)).astype(np.int32),
            "rewards": rng.normal(size=(L, B)).astype(np.float32),
            "terminated": rng.random((L, B)) < 0.2}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _post_noise(key, L, B, G, C):
    """The posterior draws' noise `rssm_observe` gets from `key`: one
    `gumbel(keys[t], (B, G, C))` a step of `split(key, L)`."""
    return torch.from_numpy(np.stack([
        np.array(jax.random.gumbel(k, (B, G, C)))
        for k in jax.random.split(key, L)]))


def _imagine_noise(key, H, N, A, G, C):
    """`imagine`'s noise from `key`: `split(key, H)`, then `ka, kz =
    split(k)` a step, the action's `gumbel(ka, (N, A))` and the
    latent's `gumbel(kz, (N, G, C))`."""
    acts, lats = [], []
    for k in jax.random.split(key, H):
        ka, kz = jax.random.split(k)
        acts.append(np.array(jax.random.gumbel(ka, (N, A))))
        lats.append(np.array(jax.random.gumbel(kz, (N, G, C))))
    return torch.from_numpy(np.stack(acts)), torch.from_numpy(np.stack(lats))


def _close(got, want, err="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=err, **(tol or TOL))


def _grads_close(tgrads, jgrads):
    want = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(tgrads) == len(want)
    for g, w in zip(tgrads, want):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)
    assert _grad_rel([g.numpy() for g in tgrads], want) <= 1e-5


# ----------------------------------------------------------------------
# numerics
# ----------------------------------------------------------------------
def test_symlog_symexp_match_jax_and_round_trip():
    x = np.array([-100.0, -1.0, -1e-4, 0.0, 0.5, 3.0, 1000.0], np.float32)
    t = torch.from_numpy(x)
    _close(td.symlog(t).numpy(), np.asarray(jd.symlog(jnp.asarray(x))))
    y = np.linspace(-6, 6, 13).astype(np.float32)
    _close(td.symexp(torch.from_numpy(y)).numpy(),
           np.asarray(jd.symexp(jnp.asarray(y))))
    _close(td.symexp(td.symlog(t)).numpy(), x)


def test_lambda_returns_match_jax_and_the_brute_force():
    rng = np.random.default_rng(0)
    H, N = 6, 3
    rewards = rng.normal(size=(H, N)).astype(np.float32)
    conts = rng.uniform(0.5, 1.0, size=(H, N)).astype(np.float32)
    values = rng.normal(size=(H, N)).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    gamma, lam = 0.9, 0.8
    got = td.lambda_returns(*(torch.from_numpy(a) for a in (
        rewards, conts, values, last)), gamma, lam).numpy()
    want = np.asarray(jd.lambda_returns(*(jnp.asarray(a) for a in (
        rewards, conts, values, last)), gamma, lam))
    _close(got, want)
    # the reference test's brute force, per env
    v_next = np.concatenate([values[1:], last[None]], axis=0)
    expect = np.zeros((H, N), np.float32)
    nxt = last
    for t in range(H - 1, -1, -1):
        expect[t] = rewards[t] + gamma * conts[t] * (
            (1 - lam) * v_next[t] + lam * nxt)
        nxt = expect[t]
    _close(got, expect)


def test_sample_categorical_draws_and_straight_through_gradient():
    """With JAX's noise, the port draws JAX's sample; the straight-
    through estimator's gradient (through the mixed softmax) equals
    JAX's, and the sample's value is the one-hot."""
    jm, tm = _models(False)
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(7, 12)).astype(np.float32) * 2
    weights = rng.normal(size=(7, 12)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (7, 3, 4))))

    def jf(lg):
        st, logp = jm._sample_categorical(key, lg)
        return jnp.sum(st * weights), (st, logp)

    (_, (jst, jlogp)), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tst, tlogp = tm._sample_categorical(tl, noise)
    (tg,) = torch.autograd.grad(torch.sum(tst * torch.from_numpy(weights)),
                                tl)
    onehot = np.asarray(jst).reshape(7, 3, 4).round()
    assert ((onehot == 0) | (onehot == 1)).all()
    assert (onehot.sum(-1) == 1).all()
    np.testing.assert_array_equal(
        tst.detach().numpy().reshape(7, 3, 4).round(), onehot)
    _close(tst.detach().numpy(), np.asarray(jst))
    _close(tlogp.detach().numpy(), np.asarray(jlogp))
    _close(tg.numpy(), np.asarray(jg))
    assert np.abs(np.asarray(jg)).max() > 1e-3


def test_generator_noise_is_finite_and_gumbel_shaped():
    gen = torch.Generator().manual_seed(0)
    g = td.gumbel((200_000,), gen, "cpu")
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean is Euler's constant, variance pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.02
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.05


@pytest.mark.parametrize("H,W,k,s", [(10, 5, 3, 2), (10, 5, 4, 2),
                                     (84, 84, 3, 2), (84, 84, 4, 2)],
                         ids=["10x5-k3s2", "10x5-k4s2", "84x84-k3s2",
                              "84x84-k4s2"])
def test_transposed_convolution_matches_jax(H, W, k, s):
    """`conv_transpose_same` against `jax.lax.conv_transpose(...,
    "SAME")` (HWIO, kernel not flipped): output, and the gradients of
    the input and the kernel; k 3 / s 2 pads (2, 1), k 4 / s 2 (2, 2)."""
    assert td.conv_transpose_padding(3, 2) == (2, 1)
    assert td.conv_transpose_padding(4, 2) == (2, 2)
    rng = np.random.default_rng(H + k)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    cot = rng.normal(size=(2, H * s, W * s, 5)).astype(np.float32)

    def jf(x, w):
        y = jax.lax.conv_transpose(x, w, (s, s), "SAME",
                                   dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC"))
        return jnp.sum(y * cot), y

    (_, want), (jgx, jgw) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(x, w)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = td.conv_transpose_same(tx, tw, s)
    assert tuple(got.shape) == want.shape == (2, H * s, W * s, 5)
    gx, gw = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)),
                                 (tx, tw))
    _close(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    _close(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-4)
    _close(gw.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-3)


# ----------------------------------------------------------------------
# the world model, imagination
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pixel", [False, True], ids=["vector", "pixel"])
def test_world_model_loss_rssm_and_imagine_match_jax(pixel):
    """`world_model_loss` (loss, metrics, every gradient leaf) with
    `rssm_observe`'s outputs (feats, prior and posterior logits, h),
    then `imagine` from its posterior states: the port's on JAX's draws
    against JAX's."""
    jm, tm = _models(pixel)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    batch = _segments(jm, seed=2)
    key = jax.random.PRNGKey(5)
    L, B = batch["prev_actions"].shape
    noise = _post_noise(key, L, B, 3, 4)

    jfe, jpr, jpo, jh = jax.jit(lambda p, b: jm.rssm_observe(
        p, key, b["obs"], b["prev_actions"]))(jparams, batch)
    tb = _tensors(batch)
    with torch.no_grad():
        tfe, tpr, tpo, th = tm.rssm_observe(
            _port(jparams), tb["obs"], tb["prev_actions"], noise=noise)
    for got, want in ((tfe, jfe), (tpr, jpr), (tpo, jpo), (th, jh)):
        _close(got.numpy(), want)

    (jl, (jmet, _jh, jfeats)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.world_model_loss(p, key, b), has_aux=True))(
            jparams, batch)
    tparams = _port(jparams, grad=True)
    tl, (tmet, thd, tfd) = tm.world_model_loss(tparams, tb, noise)
    assert not thd.requires_grad and not tfd.requires_grad
    _close(float(tl.detach()), float(jl))
    assert set(tmet) == set(jmet)
    for k in jmet:
        _close(float(tmet[k].detach()), float(jmet[k]), k)
    assert float(jmet["kl_loss"]) > 0
    tg = torch.autograd.grad(tl, tree_leaves(tparams))
    _grads_close(tg, jg)

    jactor, _ = jm.init_actor_critic(jax.random.PRNGKey(1))
    jactor = jax.tree.map(lambda a: a * 30.0, jactor)  # decisive logits
    N = L * B
    start_h = np.asarray(jh).reshape(N, -1)
    start_z = np.asarray(jfeats).reshape(N, -1)[:, 16:]
    ikey = jax.random.PRNGKey(9)
    wf, wa, wl = jax.jit(lambda p, a, h, z: jm.imagine(p, a, ikey, h, z))(
        jparams, jactor, start_h, start_z)
    with torch.no_grad():
        gf, ga, gl = tm.imagine(_port(jparams), _port(jactor),
                                torch.from_numpy(start_h),
                                torch.from_numpy(start_z),
                                _imagine_noise(ikey, 5, N, 3, 3, 4))
    assert tuple(gf.shape) == (6, N, 16 + 12)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert len(np.unique(np.asarray(wa))) == 3
    _close(gf.numpy(), wf)
    _close(gl.numpy(), wl)


def test_decode_restores_the_frame_at_atari_shape():
    """The decoder at the default filters ((16, 4, 2), (32, 4, 2)) on 84
    x 84 x 4 frames: its output has the frame's shape and equals JAX's
    decode on the same features."""
    jc, tc = jd.DreamerConfig(), td.DreamerConfig()
    for c in (jc, tc):
        c.deter_size, c.stoch_groups, c.stoch_classes = 16, 2, 4
        c.embed_hidden = c.head_hidden = (16,)
    shape = (84, 84, 4)
    jm = jd.DreamerModel(jc, 84 * 84 * 4, 3, obs_shape=shape)
    tm = td.DreamerModel(tc, 84 * 84 * 4, 3, obs_shape=shape)
    params = jm.init_params(jax.random.PRNGKey(0))
    params["decoder"]["deconv"][-1]["w"] = (
        params["decoder"]["deconv"][-1]["w"] * 100.0)
    feats = np.random.default_rng(0).normal(size=(2, 3, 24)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.decode)(params, feats))
    with torch.no_grad():
        got = tm.decode(_port(params), torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, 3, *shape)
    _close(got, want)


# ----------------------------------------------------------------------
# the two updates, against the reference's jitted ones
# ----------------------------------------------------------------------
def _built_pair(monkeypatch, pixel):
    """The JAX package's Dreamer and the port's over local runner
    groups, the port started from JAX's state (params and optax's Adam
    states: `opt_state[0]` of `optax.adam`'s chain)."""
    monkeypatch.setattr(jd, "EnvRunnerGroup", _JLocal)
    monkeypatch.setattr(td, "EnvRunnerGroup", _TLocal)
    jalgo = _config(jd, pixel).build()
    talgo = _config(td, pixel).learners(device="cpu").build()
    talgo.set_state(_jax_state(jalgo))
    return jalgo, talgo


def _adam(state):
    return {"count": state[0].count, "mu": _np(state[0].mu),
            "nu": _np(state[0].nu)}


def _jax_state(jalgo):
    return {"wm": _np(jalgo.wm_params), "actor": _np(jalgo.actor_params),
            "critic": _np(jalgo.critic_params),
            "target_critic": _np(jalgo.target_critic),
            "wm_opt": _adam(jalgo.wm_opt_state),
            "actor_opt": _adam(jalgo.actor_opt_state),
            "critic_opt": _adam(jalgo.critic_opt_state),
            "ret_std": jalgo._ret_std, "connector": None, "iteration": 0}


def _record_grads(opt):
    """The gradients each call of `opt.update` receives."""
    seen = []
    update = opt.update

    def recording(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return update(grads, state, params)

    opt.update = recording
    return seen


def _stepped_close(got_params, want_params, grads, lr, err):
    """Params after one Adam step: elements whose gradient is 0 or above
    NOISE of its leaf's largest at PARAM_TOL; the rest (a step's sign
    on rounding noise) within 2 lr."""
    for got, want, g in zip(tree_leaves(got_params),
                            jax.tree.leaves(want_params), grads):
        got, want, g = np.asarray(got), np.asarray(want), g.numpy()
        a = np.abs(g)
        held = (a > NOISE * a.max()) | (g == 0)
        np.testing.assert_allclose(got[held], want[held], err_msg=err,
                                   **PARAM_TOL)
        np.testing.assert_allclose(got[~held], want[~held], err_msg=err,
                                   rtol=0, atol=2 * lr)


def _moments_close(got, want, err):
    assert int(got["count"]) == int(want[0].count) == 1
    for part in ("mu", "nu"):
        for g, w in zip(tree_leaves(got[part]),
                        jax.tree.leaves(getattr(want[0], part))):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=err,
                                       rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("pixel", [False, True], ids=["vector", "pixel"])
def test_wm_and_ac_updates_match_the_jitted_jax_ones(monkeypatch, pixel):
    """One `_wm_update`, then one `_ac_update` from JAX's stepped world
    model and posterior states (ret_scale 1.7, so the advantage's
    scaling counts), each on JAX's draws, against the reference's
    jitted `wm_update` and `ac_update`."""
    jalgo, talgo = _built_pair(monkeypatch, pixel)
    cfg = talgo.config
    batch = _segments(jalgo.model, seed=3)
    L, B = batch["prev_actions"].shape
    k_wm, k_ac = jax.random.split(jax.random.PRNGKey(7))

    jp, jopt, jmet, jh, jz = jalgo._wm_update(
        jalgo.wm_params, jalgo.wm_opt_state, k_wm, batch)
    wm_grads = _record_grads(talgo.wm_opt)
    tmet, th, tz = talgo._wm_update(batch, noise=_post_noise(k_wm, L, B, 3,
                                                             4))
    assert set(tmet) == set(jmet)
    for k in jmet:
        _close(float(tmet[k]), float(jmet[k]), k)
    _close(th.numpy(), jh)
    _close(tz.numpy(), jz)
    _stepped_close(talgo.get_state()["wm"], jp, wm_grads[0], cfg.lr, "wm")
    _moments_close(talgo.get_state()["wm_opt"], jopt, "wm_opt")

    # the actor-critic step reads JAX's stepped world model, so that the
    # whole-lr steps on rounding noise above do not carry into it
    talgo.wm_params = talgo._trainable(params_from_numpy(_np(jp), "cpu"))
    actor0, critic0 = _np(jalgo.actor_params), _np(jalgo.critic_params)
    (ja, jc, jt, jaopt, jcopt, jacm, jstd) = jalgo._ac_update(
        jp, jalgo.actor_params, jalgo.critic_params, jalgo.target_critic,
        jalgo.actor_opt_state, jalgo.critic_opt_state, k_ac, jh, jz, 1.7)
    a_grads = _record_grads(talgo.actor_opt)
    c_grads = _record_grads(talgo.critic_opt)
    N = L * B
    tacm, tstd = talgo._ac_update(
        torch.from_numpy(np.asarray(jh)), torch.from_numpy(np.asarray(jz)),
        1.7, noise=_imagine_noise(k_ac, cfg.horizon, N, 2 + pixel, 3, 4))
    assert set(tacm) == set(jacm)
    for k in jacm:
        _close(float(tacm[k]), float(jacm[k]), k)
    _close(float(tstd), float(jstd))
    assert float(jstd) > 0 and abs(float(jacm["actor_loss"])) > 0
    state = talgo.get_state()
    _stepped_close(state["actor"], ja, a_grads[0], cfg.actor_lr, "actor")
    _stepped_close(state["critic"], jc, c_grads[0], cfg.critic_lr, "critic")
    _moments_close(state["actor_opt"], jaopt, "actor_opt")
    _moments_close(state["critic_opt"], jcopt, "critic_opt")
    # the target critic's EMA of the stepped critic
    for got, want in zip(tree_leaves(state["target_critic"]),
                         jax.tree.leaves(jt)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=2 * cfg.critic_lr * 0.02)
    for got, was in zip(tree_leaves(state["actor"]),
                        jax.tree.leaves(actor0)):
        assert got.shape == was.shape
    assert any(not np.array_equal(g, w) for g, w in zip(
        tree_leaves(state["critic"]), jax.tree.leaves(critic0)))


def test_ret_std_is_the_population_std(monkeypatch):
    """`ret_std` is `jnp.std`'s (ddof 0): the returns' std over all
    imagined entries with correction 0, not PyTorch's default 1."""
    _jalgo, talgo = _built_pair(monkeypatch, False)
    gen = torch.Generator().manual_seed(0)
    N = 8
    start_h = torch.randn((N, 16), generator=gen)
    start_z = torch.softmax(torch.randn((N, 3, 4), generator=gen),
                            -1).reshape(N, 12)
    seen = {}
    returns = td.lambda_returns

    def spy(*args):
        seen["rets"] = returns(*args)
        return seen["rets"]

    monkeypatch.setattr(td, "lambda_returns", spy)
    _m, std = talgo._ac_update(start_h, start_z, 1.0)
    rets = seen["rets"].numpy()
    _close(float(std), float(np.std(rets)), rtol=1e-6, atol=0)
    assert abs(float(std) - float(np.std(rets, ddof=1))) > 1e-3 * float(std)


# ----------------------------------------------------------------------
# the runners' numpy policy (a copy)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pixel", [False, True], ids=["vector", "pixel"])
def test_dreamer_policy_equals_the_original(monkeypatch, pixel):
    jalgo, talgo = _built_pair(monkeypatch, pixel)
    params = _np({"wm": jalgo.wm_params, "actor": jalgo.actor_params})
    params["actor"] = jax.tree.map(lambda a: a * 50.0, params["actor"])
    rng = np.random.default_rng(4)
    obs = (rng.random((6, 10, 5, 1)) < 0.2).astype(np.float32) if pixel \
        else rng.normal(size=(6, 4)).astype(np.float32)
    got = td._DreamerPolicy(talgo).forward_numpy(params, obs)
    want = jd._DreamerPolicy(jalgo).forward_numpy(params, obs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the port publishes the same policy tree as the reference
    published = talgo.env_runner_group.weights
    assert sorted(published) == ["actor", "wm"]
    for g, w in zip(tree_leaves(published["wm"]),
                    jax.tree.leaves(_np(jalgo.wm_params))):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# the reference's cases, on the port
# ----------------------------------------------------------------------
def test_dreamer_world_model_learns_dynamics():
    """The reference's case (tests/test_rllib.py:1052-1111) on the port:
    the RSSM world model fits x' = 0.9x + 0.2(2a - 1), reward -|x0|;
    reward and continue losses halve, reconstruction falls by 10%."""
    from ray_tpu_torch.models.gpt2 import AdamW
    from ray_tpu_torch.rllib.algorithms.dreamer import (
        DreamerConfig, DreamerModel,
    )

    cfg = DreamerConfig()
    cfg.deter_size, cfg.stoch_groups, cfg.stoch_classes = 32, 4, 4
    cfg.embed_hidden = cfg.head_hidden = (32,)
    model = DreamerModel(cfg, obs_dim=3, num_actions=2)
    params = tree_map(lambda t: t.requires_grad_(True), model.init_params(
        torch.Generator().manual_seed(0)))
    opt = AdamW(lambda _c: 3e-3, max_norm=float("inf"), b1=0.9, b2=0.999,
                eps=1e-8, weight_decay=0.0)
    opt_state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(0)

    def make_batch():
        L, B = 8, 16
        obs = np.zeros((L, B, 3), np.float32)
        acts = rng.integers(0, 2, (L, B)).astype(np.int32)
        x = rng.normal(size=(B, 3)).astype(np.float32)
        for t in range(L):
            obs[t] = x
            x = 0.9 * x + 0.2 * (2 * acts[t, :, None] - 1)
        return _tensors({
            "obs": obs,
            "prev_actions": np.concatenate(
                [np.zeros((1, B), np.int32), acts[:-1]], axis=0),
            "rewards": -np.abs(obs[..., 0]),
            "terminated": np.zeros((L, B), bool),
        })

    first = None
    for _ in range(60):
        loss, (m, _h, _f) = model.world_model_loss(params, make_batch(),
                                                   generator=gen)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        opt_state, _ = opt.update(list(grads), opt_state, params)
        m = {k: float(v.detach()) for k, v in m.items()}
        first = first or m
    last = m
    assert last["reward_loss"] < first["reward_loss"] * 0.5, (first, last)
    assert last["cont_loss"] < first["cont_loss"] * 0.5, (first, last)
    assert last["recon_loss"] < first["recon_loss"] * 0.9, (first, last)


def _cartpole_config():
    cfg = td.DreamerConfig()
    cfg.environment("CartPole-v1")
    cfg.env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                    rollout_fragment_length=32)
    cfg.debugging(seed=0)
    cfg.learners(device="cpu")
    cfg.deter_size, cfg.stoch_groups, cfg.stoch_classes = 64, 4, 4
    cfg.embed_hidden = cfg.head_hidden = (64,)
    cfg.num_updates_per_iter = 2
    cfg.batch_segments = 8
    return cfg


def test_dreamer_trains_on_cartpole(cluster):
    """The reference's case (tests/test_rllib.py:1114-1139): replay
    fills, both updates run, the policy syncs, metrics stay finite and
    the world model improves."""
    algo = _cartpole_config().build()
    try:
        results = within(120.0, lambda: [algo.train() for _ in range(3)])
        last = results[-1]
        for k in ("wm_loss", "actor_loss", "critic_loss",
                  "imagined_return_mean"):
            assert np.isfinite(last[k]), (k, last)
        assert last["replay_rows"] >= 3 * 4 * 32
        assert last["wm_loss"] < results[0]["wm_loss"], results
    finally:
        algo.stop()


def test_checkpoint_restores_the_policy_the_first_rollout_uses(
        cluster, tmp_path):
    """A checkpoint written after two iterations, loaded into a fresh
    algorithm: its four trees and three Adam states equal the saved
    ones, and the weights it publishes to the runners (which the first
    rollout after the restore uses) are the restored policy's, bit for
    bit, not the fresh init's."""
    algo = _cartpole_config().build()
    try:
        within(120.0, lambda: [algo.train() for _ in range(2)])
        algo.save_checkpoint(str(tmp_path))
        saved = algo.get_state()
    finally:
        algo.stop()
    fresh = _cartpole_config().debugging(seed=1).build()
    try:
        init_actor = fresh.get_state()["actor"]
        fresh.load_checkpoint(str(tmp_path))
        got = fresh.get_state()
        for key in ("wm", "actor", "critic", "target_critic"):
            for g, w in zip(tree_leaves(got[key]), tree_leaves(saved[key])):
                np.testing.assert_array_equal(g, w, err_msg=key)
        for key in ("wm_opt", "actor_opt", "critic_opt"):
            assert int(got[key]["count"]) == int(saved[key]["count"]) == 4
            for part in ("mu", "nu"):
                for g, w in zip(tree_leaves(got[key][part]),
                                tree_leaves(saved[key][part])):
                    np.testing.assert_array_equal(g, w)
        assert got["ret_std"] == saved["ret_std"]
        assert got["iteration"] == saved["iteration"] == 2
        group = fresh.env_runner_group
        published = rt.get(group._weights_refs[-1]["ref"], timeout=60)
        for part in ("wm", "actor"):
            for g, w in zip(tree_leaves(published[part]),
                            tree_leaves(saved[part])):
                np.testing.assert_array_equal(g, w)
        assert any(not np.array_equal(g, w) for g, w in zip(
            tree_leaves(published["actor"]), tree_leaves(init_actor)))
        r = within(60.0, fresh.train)
        assert np.isfinite(r["critic_loss"]) and r["replay_rows"] == 128
    finally:
        fresh.stop()

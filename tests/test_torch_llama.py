"""Port parity: `ray_tpu_torch.models.llama` against the JAX package's
`ray_tpu.models.llama` on the tiny config in f32.

The JAX params cross to the port through the weight bridge, so both
sides hold the same weights; inputs come from seeded numpy (RT008).
Model functions agree at rtol/atol 1e-5 (f32 matmuls summed in another
order); greedy tokens are equal.  The JAX `decode_step_paged` runs its
Pallas kernels in interpret mode, as its own tests do on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu_torch.examples.serve_llm import MODEL_SIZES, _build_model  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.bridge import (  # noqa: E402
    params_from_numpy, params_to_numpy,
)
from ray_tpu_torch.parallel.ring_attention import select_attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this file from crowding the timing-sensitive tests that other
    workers of a parallel run execute meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(shape, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# config, init, bridge
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["llama2_7b", "llama3_8b", "tiny"])
def test_config_matches_jax(name):
    j = getattr(jllama.LlamaConfig, name)()
    t = getattr(tllama.LlamaConfig, name)()
    for f in ("vocab_size", "max_seq_len", "dim", "n_layers", "n_heads",
              "n_kv_heads", "intermediate", "rope_theta", "norm_eps",
              "attention", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def test_init_params_layout_matches_jax_and_is_seeded(model):
    jcfg, jparams, tcfg, _ = model
    a = tllama.init_params(tcfg, 3, device="cpu")
    b = tllama.init_params(tcfg, 3, device="cpu")
    c = tllama.init_params(tcfg, 4, device="cpu", dtype=torch.bfloat16)
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    assert jax.tree.map(lambda x: tuple(x.shape), params_to_numpy(a)) == \
        jshapes
    for k in ("tok_emb", "lm_head"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k].float())
        assert c[k].dtype == torch.bfloat16
    assert torch.equal(a["blocks"]["attn_norm"], torch.ones(2, 64))
    # std 0.02 draws; projections scaled by 1/sqrt(2L)
    assert abs(float(a["tok_emb"].std()) - 0.02) < 2e-3
    assert float(a["blocks"]["wo"].std()) < float(a["blocks"]["wq"].std())


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
def test_bridge_round_trips_bit_exactly(model, variant):
    _, jparams, _, _ = model
    if variant == "bf16":
        jparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
    elif variant == "int8":
        jparams = jllama.quantize_weights_int8(jparams)
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    # dtype= casts the floating leaves only; int8 payloads keep theirs
    cast = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    for leaf in jax.tree.leaves(cast):
        want = torch.int8 if variant == "int8" and leaf.dtype == torch.int8 \
            else torch.bfloat16
        assert leaf.dtype == want


def test_build_model_sizes():
    assert MODEL_SIZES == ("tiny", "llama1b4", "llama2_7b", "llama3_8b")
    cfg, params = _build_model("tiny", seed=0, device="cpu")
    assert cfg == tllama.LlamaConfig.tiny()
    assert params["blocks"]["wq"].shape == (2, 64, 64)
    assert params["tok_emb"].dtype == torch.float32  # tiny stays f32
    with pytest.raises(ValueError, match="model_size"):
        _build_model("gpt5", seed=0, device="cpu")


# ----------------------------------------------------------------------
# forward and prefill paths
# ----------------------------------------------------------------------
def test_forward_with_kv_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _tokens((2, 10), seed=1)
    jl, (jk, jv) = jllama.forward(jcfg, jparams, jnp.asarray(toks),
                                  return_kv=True)
    tl, (tk, tv) = tllama.forward(tcfg, tparams, torch.from_numpy(toks),
                                  return_kv=True)
    assert tl.dtype == torch.float32 and tk.shape == tuple(jk.shape)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    _close(tllama.forward(tcfg, tparams, torch.from_numpy(toks)), jl)


@pytest.mark.parametrize("prefix_len,pmax", [(8, 8), (5, 8)])
def test_forward_with_prefix_matches_jax(model, prefix_len, pmax):
    """A gathered prefix of Pmax columns, of which prefix_len are live
    (the rest is block padding, masked)."""
    jcfg, jparams, tcfg, tparams = model
    toks = _tokens((2, prefix_len + 6), seed=2)
    _, (pk, pv) = jllama.forward(jcfg, jparams,
                                 jnp.asarray(toks[:, :prefix_len]),
                                 return_kv=True)
    pad = [(0, 0), (0, 0), (0, pmax - prefix_len), (0, 0), (0, 0)]
    pk, pv = jnp.pad(pk, pad), jnp.pad(pv, pad)
    suffix = toks[:, prefix_len:]
    jl, (jk, jv) = jllama.forward_with_prefix(
        jcfg, jparams, jnp.asarray(suffix), (pk, pv), prefix_len)
    tl, (tk, tv) = tllama.forward_with_prefix(
        tcfg, tparams, torch.from_numpy(suffix),
        (torch.from_numpy(np.array(pk)), torch.from_numpy(np.array(pv))),
        prefix_len)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    # and it reproduces the full forward's suffix logits
    full = tllama.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(full[:, prefix_len:]), **TOL)


def test_prefill_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _tokens((3, 7), seed=3)
    jl, (jk, jv) = jllama.prefill(jcfg, jparams, jnp.asarray(toks), 16)
    tl, (tk, tv) = tllama.prefill(tcfg, tparams, torch.from_numpy(toks), 16)
    assert tk.shape == tuple(jk.shape)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


# ----------------------------------------------------------------------
# decode steps
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def prefilled(model):
    """A batch of 3 prompts of 6 prefilled into a 16-slot cache."""
    jcfg, jparams, _, _ = model
    toks = _tokens((3, 6), seed=5)
    logits, cache = jllama.prefill(jcfg, jparams, jnp.asarray(toks), 16)
    tok = np.array(jnp.argmax(logits, -1).astype(jnp.int32))
    return tok, tuple(np.array(c) for c in cache)


def _tcache(cache):
    return tuple(torch.from_numpy(c.copy()) for c in cache)


def test_decode_step_matches_jax(model, prefilled):
    jcfg, jparams, tcfg, tparams = model
    tok, cache = prefilled
    jl, jc = jllama.decode_step(jcfg, jparams, jnp.asarray(tok),
                                tuple(map(jnp.asarray, cache)),
                                jnp.asarray(6, jnp.int32))
    tl, tc = tllama.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                _tcache(cache), 6)
    _close(tl, jl)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


def test_decode_step_vec_matches_jax(model, prefilled):
    """Ragged per-row positions, one of them past the cache (writes
    nothing, attends over every column)."""
    jcfg, jparams, tcfg, tparams = model
    tok, cache = prefilled
    pos = np.asarray([6, 3, 16], np.int32)
    jl, jc = jllama.decode_step_vec(jcfg, jparams, jnp.asarray(tok),
                                    tuple(map(jnp.asarray, cache)),
                                    jnp.asarray(pos))
    tl, tc = tllama.decode_step_vec(tcfg, tparams, torch.from_numpy(tok),
                                    _tcache(cache), torch.from_numpy(pos))
    _close(tl, jl)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


def test_decode_step_vec_equals_scalar_step_at_equal_positions(model,
                                                               prefilled):
    _, _, tcfg, tparams = model
    tok, cache = prefilled
    ls, cs = tllama.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                _tcache(cache), 6)
    lv, cv = tllama.decode_step_vec(tcfg, tparams, torch.from_numpy(tok),
                                    _tcache(cache),
                                    torch.full((3,), 6, dtype=torch.int32))
    np.testing.assert_allclose(_np(ls), _np(lv), **TOL)
    np.testing.assert_allclose(_np(cs[0]), _np(cv[0]), **TOL)


def _paged(cache, BS=4, seed=9):
    """Dense [L, B, M, KV, hd] cache -> pool blocks behind a shuffled
    table (block 0 = scratch)."""
    kc, vc = cache
    L, B, M, KV, hd = kc.shape
    W = M // BS
    NB = 1 + B * W
    tables = np.random.default_rng(seed).permutation(
        np.arange(1, NB)).reshape(B, W).astype(np.int32)
    kp = np.zeros((L, NB, BS, KV, hd), kc.dtype)
    vp = np.zeros_like(kp)
    for b in range(B):
        for w in range(W):
            kp[:, tables[b, w]] = kc[:, b, w * BS:(w + 1) * BS]
            vp[:, tables[b, w]] = vc[:, b, w * BS:(w + 1) * BS]
    return kp, vp, tables


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_decode_step_paged_matches_jax(model, prefilled, kv):
    """The fused route (port: plain versions on the CPU; JAX: Pallas in
    interpret mode) from a prefilled cache scattered into shuffled
    blocks: logits and the updated pools (scales too) agree."""
    jcfg, jparams, tcfg, tparams = model
    tok, cache = prefilled
    kp, vp, tables = _paged(cache)
    pos = np.asarray([6, 5, 9], np.int32)
    jargs = [jnp.asarray(a) for a in (tok, kp, vp, tables, pos)]
    targs = [torch.from_numpy(a.copy()) for a in (tok, kp, vp, tables, pos)]
    if kv == "int8":
        kq, ks = map(np.asarray, jpa.quantize_int8(jnp.asarray(kp)))
        vq, vs = map(np.asarray, jpa.quantize_int8(jnp.asarray(vp)))
        jargs[1:3] = [jnp.asarray(kq), jnp.asarray(vq)]
        targs[1:3] = [torch.from_numpy(kq.copy()), torch.from_numpy(vq.copy())]
        jout = jllama.decode_step_paged(jcfg, jparams, *jargs,
                                        kv_scales=(jnp.asarray(ks),
                                                   jnp.asarray(vs)))
        tout = tllama.decode_step_paged(
            tcfg, tparams, *targs,
            kv_scales=(torch.from_numpy(ks.copy()),
                       torch.from_numpy(vs.copy())))
    else:
        jout = jllama.decode_step_paged(jcfg, jparams, *jargs)
        tout = tllama.decode_step_paged(tcfg, tparams, *targs)
    assert len(tout) == len(jout) == (5 if kv == "int8" else 3)
    _close(tout[0], jout[0])
    for t, j in zip(tout[1:], jout[1:]):
        if t.dtype == torch.int8:  # requantized rows: equal payloads
            np.testing.assert_array_equal(_np(t)[:, 1:], np.asarray(j)[:, 1:])
        else:
            np.testing.assert_allclose(_np(t)[:, 1:], np.asarray(j)[:, 1:],
                                       **TOL)


def test_decode_step_paged_equals_decode_step_vec(model, prefilled):
    """Within the port: the paged route over the pool equals the dense
    route over the same KV (the engine's kernel vs gather routes)."""
    _, _, tcfg, tparams = model
    tok, cache = prefilled
    kp, vp, tables = _paged(cache)
    pos = torch.tensor([6, 5, 9], dtype=torch.int32)
    lp = tllama.decode_step_paged(tcfg, tparams, torch.from_numpy(tok),
                                  torch.from_numpy(kp), torch.from_numpy(vp),
                                  torch.from_numpy(tables), pos)[0]
    lv, _ = tllama.decode_step_vec(tcfg, tparams, torch.from_numpy(tok),
                                   _tcache(cache), pos)
    np.testing.assert_allclose(_np(lp), _np(lv), **TOL)


# ----------------------------------------------------------------------
# int8 weights, generate, attention dispatch
# ----------------------------------------------------------------------
def test_quantize_weights_int8_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jq = jllama.quantize_weights_int8(jparams)
    tq = tllama.quantize_weights_int8(tparams)
    for name in tllama.QUANT_TARGETS:
        np.testing.assert_array_equal(_np(tq["blocks"][name]),
                                      np.asarray(jq["blocks"][name]))
        np.testing.assert_allclose(_np(tq["blocks"][name + "_scale"]),
                                   np.asarray(jq["blocks"][name + "_scale"]),
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_np(tq["lm_head"]),
                                  np.asarray(jq["lm_head"]))
    assert "lm_head_scale" in tq and tparams.get("lm_head_scale") is None
    toks = _tokens((2, 8), seed=4)
    _close(tllama.forward(tcfg, tq, torch.from_numpy(toks)),
           jllama.forward(jcfg, jq, jnp.asarray(toks)))


@pytest.mark.parametrize("T,n_new", [(1, 5), (7, 9), (13, 4)])
def test_generate_greedy_equals_jax(model, T, n_new):
    jcfg, jparams, tcfg, tparams = model
    prompt = _tokens((2, T), seed=T)
    want = np.asarray(jllama.generate(jcfg, jparams, jnp.asarray(prompt),
                                      n_new))
    got = tllama.generate(tcfg, tparams, prompt, n_new, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


def test_generate_sampling_is_seeded(model):
    _, _, tcfg, tparams = model
    prompt = _tokens((2, 5), seed=8)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tllama.generate(tcfg, tparams, prompt, 12, temperature=1.0,
                               generator=gen, device="cpu")

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["flash", "ring", "ulysses", "sparse"])
def test_select_attention_matches_jax_without_mesh(kind, causal):
    """With no mesh every kind answers as the reference's dispatch:
    flash through the flash op, ring / ulysses / an unknown kind through
    plain attention (f32, 1e-5)."""
    from ray_tpu.parallel.ring_attention import select_attention as jsel

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    want = jsel(kind, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal)
    got = select_attention(kind, torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_backends_over_a_mesh_raise(kind):
    """Given a mesh, ring / ulysses run over its sp axis (held against
    the JAX package on gloo ranks in test_torch_parallel.py), so
    anything that is not a `DeviceMesh` raises; with no mesh they run
    dense attention, as in the reference."""
    q, k, v = (torch.from_numpy(np.random.default_rng(s).standard_normal(
        (1, 8, 2, 8)).astype(np.float32)) for s in (1, 2, 3))
    with pytest.raises(AttributeError):
        select_attention(kind, q, k, v, mesh=object())
    torch.testing.assert_close(select_attention(kind, q, k, v),
                               select_attention("dense", q, k, v),
                               rtol=0, atol=0)

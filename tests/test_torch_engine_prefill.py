"""The engine's prefill program families against the JAX engine's.

The JAX engine runs its admissions from three families of compiled
programs, each keyed by a static shape: the full prefill by pow-2 prompt
bucket (capped at `max_len - 1`), the radix-hit suffix prefill by
(suffix bucket, prefix blocks padded to a pow-2), and the block write by
(rows in, blocks written).  The port's engine keeps the same three
families under the same keys (eager functions on the CPU, CUDA graphs on
the card).  Here both engines, on a tiny f32 config with the JAX params
bridged to the port, serve the same seeded prompts: lengths in every
bucket up to the cap, prefixes shared so that later prompts take the
suffix path (with a padded prefix width, and a suffix at the cap), and
more requests than slots; with model-dtype and int8 KV, and int8
weights.  Greedy tokens, the prefill counters and the three caches'
keys must be equal.  Each engine's serve runs under `within`.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_engine_prefill.py -q

All draws seeded (RT008).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_waits import within

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.serve.llm_engine import LlamaEngine as JaxEngine  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.llm_engine import LlamaEngine  # noqa: E402

# max_len 48: buckets 1, 2, 4, ..., 32 and the cap 47; a pool that holds
# every donated block beside the live ones, so no radix node is evicted
# and every prefix hit is decided by arrival order alone
ENGINE = dict(slots=3, chunk=4, block_size=8, max_len=48, kv_blocks=64)
COUNTERS = ("prefill_calls", "prefill_tokens", "prefix_hit_tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this file from crowding the other workers of a parallel run."""
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
    return jcfg, jparams, tcfg


def workload():
    """(prompts, new tokens): lengths 1 to 46 (bucket 47 is the cap),
    then prompts over shared prefixes of 1, 2 and 3 blocks, each prefix
    first donated by a full prefill; the last suffix (38 tokens) takes
    the capped suffix bucket, the 3-block prefix the padded width 4."""
    rng = np.random.default_rng(11)

    def toks(n):
        return [int(t) for t in rng.integers(1, 128, size=n)]

    prompts = [toks(n) for n in (1, 2, 3, 5, 9, 17, 33, 46)]
    p8, p16, p24 = toks(8), toks(16), toks(24)
    prompts += [
        p16 + toks(5),    # donates p16's 2 blocks
        p16 + toks(20),   # suffix 20 over 2 blocks: (32, 2)
        p16 + toks(3),    # suffix 3: (4, 2)
        p24 + toks(9),    # donates p24's 3 blocks and one more
        p24 + toks(10),   # suffix 10 over 3 blocks padded to 4: (16, 4)
        p8 + toks(4),     # donates p8's block
        p8 + toks(38),    # suffix 38 at the cap: (47, 1)
    ]
    n_new = [int(n) for n in rng.integers(2, 9, size=len(prompts))]
    return prompts, n_new


def _serve(engine, prompts, n_new):
    try:
        outs = within(240, lambda: [
            f.result(timeout=200)
            for f in [engine.submit(p, n) for p, n in zip(prompts, n_new)]])
        stats = engine.stats()
        # read before `shutdown`, which empties the port's caches
        keys = {name: sorted(getattr(engine, name)) for name in
                ("_prefill_cache", "_suffix_cache", "_write_cache")}
    finally:
        engine.shutdown()
    return outs, {k: stats[k] for k in COUNTERS}, keys


@pytest.mark.parametrize("kv_dtype,weights", [
    ("model", "f32"), ("int8", "f32"), ("int8", "int8")])
def test_prefill_families_match_the_jax_engine(model, kv_dtype, weights):
    jcfg, jparams, tcfg = model
    if weights == "int8":
        jparams = jllama.quantize_weights_int8(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompts, n_new = workload()
    jout, jcount, jkeys = _serve(
        JaxEngine(jcfg, jparams, kv_dtype=kv_dtype, **ENGINE),
        prompts, n_new)
    tout, tcount, tkeys = _serve(
        LlamaEngine(tcfg, tparams, kv_dtype=kv_dtype, device="cpu",
                    **ENGINE), prompts, n_new)
    assert tout == jout
    assert [len(o) for o in tout] == [
        min(n, ENGINE["max_len"] - 1 - len(p))
        for p, n in zip(prompts, n_new)]
    assert tcount == jcount
    assert tcount["prefill_calls"] == len(prompts)
    assert tcount["prefix_hit_tokens"] == 16 + 16 + 24 + 8
    assert tkeys == jkeys
    # every bucket up to the cap, both suffix-path paddings, and writes
    # from each prefill shape
    assert tkeys["_prefill_cache"] == [1, 2, 4, 8, 16, 32, 47]
    assert tkeys["_suffix_cache"] == [(4, 2), (16, 4), (32, 2), (47, 1)]
    assert (47, 6) in tkeys["_write_cache"]


def test_prefill_entries_equal_exact_length_prefill(model):
    """A bucketed full prefill's staged logits row T - 1 and the KV it
    stages for the block write equal an exact-length forward's (f32,
    within rounding), and the pad rows of the last block stay masked:
    the engine's first token equals `generate`'s."""
    _, jparams, tcfg = model
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    eng = LlamaEngine(tcfg, tparams, device="cpu", **ENGINE)
    try:
        prompt = workload()[0][6]  # 33 tokens: bucket 64, capped at 47
        T = len(prompt)
        bucket = min(1 << (T - 1).bit_length(), ENGINE["max_len"] - 1)
        padded = torch.as_tensor([prompt + [0] * (bucket - T)])
        eng._prefill_for(bucket)(padded, torch.tensor(T - 1))
        want, (kw, _) = tllama.forward(tcfg, tparams,
                                       torch.as_tensor([prompt]),
                                       return_kv=True)
        torch.testing.assert_close(eng._stage_logits, want[0, T - 1],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(eng._stage_k[:, :T], kw[:, 0], rtol=1e-5,
                                   atol=1e-5)
        got = within(120, lambda: eng.submit(prompt, 5).result(timeout=100))
    finally:
        eng.shutdown()
    assert got == tllama.generate(tcfg, tparams, [prompt], 5,
                                  device="cpu")[0].tolist()

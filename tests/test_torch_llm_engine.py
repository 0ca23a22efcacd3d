"""Port parity: `ray_tpu_torch.serve.llm_engine.LlamaEngine` against
the JAX package's engine, `generate` on both sides, and its own routes.

The invariant, as in the reference: greedy decoding is deterministic
and rows are independent, so every request the shared-slot engine
serves gives EXACTLY the tokens a dedicated `generate` gives — across
queueing beyond the slot count, slot reuse, radix prefix hits and LRU
eviction.  On the tiny f32 config the port's engine (both routes,
prefix cache on and off) equals the JAX engine (its Pallas route in
interpret mode, and its gather route), the JAX `generate` and the
port's `generate`.  Within the port at bf16 the kernel route equals the
gather route token for token, with model-dtype and int8 KV.  All RNGs
seeded (RT008); small engines keep the file fast.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.serve.llm_engine import LlamaEngine as JaxEngine  # noqa: E402
from ray_tpu_torch.exceptions import (  # noqa: E402
    BackPressureError, DeadlineExceededError, GetTimeoutError, RayTpuError,
)
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.kv_cache import (  # noqa: E402
    KV_DTYPES, SCRATCH_BLOCK, BlockPool, RadixCache,
)
from ray_tpu_torch.serve.llm_engine import LlamaEngine  # noqa: E402

SMALL = dict(slots=4, chunk=4, block_size=8, max_len=64)


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


@pytest.fixture(scope="module")
def workload():
    """7 requests (> 4 slots): mixed lengths and budgets, three of them
    sharing a 2-block (16-token) prefix so the radix cache hits."""
    rng = np.random.default_rng(42)
    shared = [int(t) for t in rng.integers(0, 128, size=16)]
    prompts, n_new = [], []
    for i in range(7):
        T = int(rng.integers(1, 24))
        tail = [int(t) for t in rng.integers(0, 128, size=T)]
        prompts.append(shared + tail[:4] if i in (1, 3, 5) else tail)
        n_new.append(int(rng.integers(1, 10)))
    return prompts, n_new


def _serve(engine, prompts, n_new):
    try:
        futs = [engine.submit(p, n) for p, n in zip(prompts, n_new)]
        return [f.result(timeout=120) for f in futs], engine.stats()
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_reference(model, workload):
    """The JAX side, computed once: its engine on the Pallas route
    (interpret mode, prefix cache on) and the gather route (prefix
    cache off), and its dedicated `generate` per request."""
    jcfg, jparams, _, _ = model
    prompts, n_new = workload
    pallas, s_p = _serve(JaxEngine(jcfg, jparams, decode_kernel="pallas",
                                   **SMALL), prompts, n_new)
    gather, s_g = _serve(JaxEngine(jcfg, jparams, decode_kernel="gather",
                                   prefix_cache=False, **SMALL),
                         prompts, n_new)
    assert s_p["decode_kernel"] == "pallas" and s_p["prefix_hit_tokens"] > 0
    assert s_g["decode_kernel"] == "gather"
    generate = [
        [int(t) for t in np.asarray(jllama.generate(
            jcfg, jparams, jnp.asarray([p], jnp.int32), n))[0]]
        for p, n in zip(prompts, n_new)
    ]
    return {"pallas": pallas, "gather": gather, "generate": generate}


@pytest.fixture(scope="module")
def port_generate(model, workload):
    _, _, tcfg, tparams = model
    prompts, n_new = workload
    return [tllama.generate(tcfg, tparams, [p], n, device="cpu")[0].tolist()
            for p, n in zip(prompts, n_new)]


@pytest.mark.parametrize("route", ["auto", "gather"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_greedy_equals_jax_engine_and_generate(
        model, workload, jax_reference, port_generate, route, prefix_cache):
    _, _, tcfg, tparams = model
    prompts, n_new = workload
    outs, st = _serve(LlamaEngine(tcfg, tparams, decode_kernel=route,
                                  prefix_cache=prefix_cache, device="cpu",
                                  **SMALL), prompts, n_new)
    assert jax_reference["pallas"] == jax_reference["gather"] \
        == jax_reference["generate"]
    assert port_generate == jax_reference["generate"]
    assert outs == jax_reference["generate"]
    want_route = "gather" if route == "gather" else "kernel"
    assert st["decode_kernel"] == want_route
    kernel_ticks = st["decode_kernel_dispatch_total"]
    gather_ticks = st["decode_fallback_dispatch_total"]
    assert (kernel_ticks > 0 and gather_ticks == 0) if want_route == \
        "kernel" else (kernel_ticks == 0 and gather_ticks > 0)
    if prefix_cache:
        assert st["prefix_hit_tokens"] >= 2 * 16
    else:
        assert st["prefix_hit_tokens"] == 0
    assert st["active"] == 0 and st["queued"] == 0


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_bf16_kernel_route_equals_gather_route(model, workload, kv_dtype):
    """Within the port at bf16 (the serving dtype): the fused route and
    the gather reference see the same stored KV, so their greedy tokens
    agree exactly — with int8 KV too."""
    _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    prompts, n_new = workload
    on, s_on = _serve(LlamaEngine(cfg, tparams, decode_kernel="kernel",
                                  kv_dtype=kv_dtype, device="cpu", **SMALL),
                      prompts, n_new)
    off, s_off = _serve(LlamaEngine(cfg, tparams, decode_kernel="gather",
                                    kv_dtype=kv_dtype, device="cpu",
                                    **SMALL), prompts, n_new)
    assert on == off
    assert s_on["kv_dtype"] == s_off["kv_dtype"] == kv_dtype
    assert s_on["decode_kernel_dispatch_total"] > 0
    assert s_off["decode_fallback_dispatch_total"] > 0


def test_int8_pool_is_half_the_bf16_payload(model):
    _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    sizes = {}
    for kv in KV_DTYPES:
        eng = LlamaEngine(cfg, tparams, kv_dtype=kv, kv_blocks=32,
                          device="cpu", **SMALL)
        sizes[kv] = eng.stats()
        eng.shutdown()
    assert sizes["int8"]["kv_pool_bytes"] * 2 == sizes["model"]["kv_pool_bytes"]
    assert sizes["model"]["kv_scale_bytes"] == 0
    assert sizes["int8"]["kv_scale_bytes"] > 0


def test_eviction_churned_pool_stays_exact(model):
    """A pool too small to cache every prompt: LRU eviction fires, block
    tables end up ragged and non-contiguous, outputs stay exact and no
    block leaks."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(9)
    eng = LlamaEngine(tcfg, tparams, slots=2, chunk=2, block_size=8,
                      max_len=48, kv_blocks=12, device="cpu")
    try:
        for _round in range(3):
            prompts = [[int(x) for x in rng.integers(0, 128, size=T)]
                       for T in (17, 20, 19, 18)]
            futs = [eng.submit(p, 6) for p in prompts]
            for p, fut in zip(prompts, futs):
                assert fut.result(timeout=120) == tllama.generate(
                    tcfg, tparams, [p], 6, device="cpu")[0].tolist()
        st = eng.stats()
        assert eng._radix.evicted_blocks > 0
        assert st["blocks_free"] + st["blocks_cached"] == st["blocks_total"]
        assert st["decode_kernel_dispatch_total"] > 0
    finally:
        eng.shutdown()


def test_gather_width_tracks_live_tokens_not_pool_budget(model):
    _, _, tcfg, tparams = model
    prompt = [int(x) for x in np.random.default_rng(3).integers(0, 128, 24)]
    widths = {}
    for label, kv_blocks in (("sized", 12), ("over", 128)):
        eng = LlamaEngine(tcfg, tparams, slots=2, max_len=48, chunk=4,
                          block_size=8, kv_blocks=kv_blocks, device="cpu")
        try:
            eng.submit(prompt, 8).result(timeout=120)
            widths[label] = eng.stats()["gather_blocks"]
        finally:
            eng.shutdown()
    assert widths["sized"] == widths["over"] > 0
    assert widths["over"] <= 8


# ----------------------------------------------------------------------
# validation, overload and failure handling
# ----------------------------------------------------------------------
def test_engine_validates_and_clamps(model):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="decode_kernel"):
        LlamaEngine(tcfg, tparams, decode_kernel="pallas", device="cpu")
    with pytest.raises(ValueError, match="kv_blocks"):
        LlamaEngine(tcfg, tparams, slots=2, max_len=48, block_size=8,
                    kv_blocks=5, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        LlamaEngine(tcfg, tparams, kv_dtype="fp8", device="cpu")
    eng = LlamaEngine(tcfg, tparams, slots=2, max_len=32, chunk=2,
                      device="cpu")
    try:
        with pytest.raises(ValueError):
            eng.submit([], 4).result(timeout=10)
        with pytest.raises(ValueError):
            eng.submit(list(range(40)), 4).result(timeout=10)
        # budget clamped to the sequence cap: T=20 -> at most 11 new
        out = eng.submit(list(range(1, 21)), 500).result(timeout=120)
        assert len(out) == 32 - 1 - 20
        st = eng.stats()
        assert st["active"] == 0 and st["free_slots"] == 2
        assert st["decode_kernel"] == "kernel"  # "auto" resolves here
        assert st["ttft_p50_s"] > 0 and st["ttft_p90_s"] >= st["ttft_p50_s"]
    finally:
        eng.shutdown()


def test_overload_rejects_sheds_and_drains(model):
    _, _, tcfg, tparams = model
    eng = LlamaEngine(tcfg, tparams, slots=1, max_len=32, chunk=2,
                      max_queued=0, device="cpu")
    try:
        with pytest.raises(DeadlineExceededError) as ei:
            eng.submit([1, 2], 2, timeout_s=0.0).result(timeout=10)
        assert isinstance(ei.value, GetTimeoutError)
        assert ei.value.timeout_s == 0.0
        # max_queued=0: one free slot admits one request, nothing queues
        first = eng.submit([1, 2, 3], 20)
        with pytest.raises(BackPressureError) as bp:
            eng.submit([4, 5], 2).result(timeout=10)
        assert bp.value.retry_after_s > 0
        assert "retry_after_s=" in str(bp.value)
        assert len(first.result(timeout=120)) == 20
        eng.begin_drain()
        with pytest.raises(BackPressureError, match="draining"):
            eng.submit([1], 1).result(timeout=10)
        st = eng.stats()
        assert st["rejected_total"] == 2 and st["shed_expired"] == 1
        assert st["draining"] == 1.0
    finally:
        eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1], 1).result(timeout=10)
    assert issubclass(BackPressureError, RayTpuError)


def test_failed_tick_fails_every_future_then_recovers(model, monkeypatch):
    """A tick that raises fails each live request with the exception,
    resets the pool bookkeeping, and the engine serves the next
    request normally."""
    _, _, tcfg, tparams = model
    eng = LlamaEngine(tcfg, tparams, device="cpu", **SMALL)
    try:
        boom = RuntimeError("injected chunk failure")
        real = eng._run_chunk
        calls = {"n": 0}

        def failing(tables):
            calls["n"] += 1
            if calls["n"] == 1:
                raise boom
            return real(tables)

        monkeypatch.setattr(eng, "_run_chunk", failing)
        futs = [eng.submit([1, 2, 3], 4), eng.submit([4, 5], 3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=60)
        st = eng.stats()
        assert st["active"] == 0 and st["blocks_free"] == st["blocks_total"]
        got = eng.submit([7, 8, 9], 5).result(timeout=60)
        assert got == tllama.generate(tcfg, tparams, [[7, 8, 9]], 5,
                                      device="cpu")[0].tolist()
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# kv_cache bookkeeping units (the reference's cases, on the port's copy)
# ----------------------------------------------------------------------
def test_block_pool_alloc_free_accounting():
    pool = BlockPool(8)
    assert pool.capacity == 7 and SCRATCH_BLOCK == 0
    got = pool.alloc(7)
    assert sorted(got) == list(range(1, 8))  # scratch block 0 reserved
    assert pool.alloc(1) is None
    pool.free(got[:3])
    assert pool.free_blocks == 3
    with pytest.raises(ValueError):
        pool.free([0])
    with pytest.raises(ValueError):
        BlockPool(1)
    with pytest.raises(ValueError):
        pool.alloc(-1)


def test_radix_cache_match_insert_evict():
    pool = BlockPool(16)
    cache = RadixCache(4, pool)
    toks = list(range(1, 14))  # 13 tokens -> 3 shareable 4-blocks
    blocks, path = cache.match(toks)
    assert blocks == [] and path == []
    own = pool.alloc(3)
    path, adopted = cache.insert(toks, path, own)
    assert adopted == own and cache.cached_blocks == 3
    assert cache.evict(10) == 0  # pinned
    cache.release(path)
    blocks2, path2 = cache.match(toks + [99])
    assert blocks2 == own
    assert cache.evict(10) == 0  # pinned again
    cache.release(path2)
    freed = cache.evict(2)
    assert freed == 2 and cache.cached_blocks == 1
    assert pool.free_blocks == pool.capacity - 1
    assert cache.evict(5) == 1 and cache.cached_blocks == 0

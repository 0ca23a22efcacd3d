"""The engine's chunk steppers: one per gather width, LRU-bounded at
`chunk_cache_cap`, each a CUDA graph of the whole decode chunk on the
card's kernel route; and the engine's env knobs.

CPU tests (tiny f32 engines): the reference's LRU test
(`tests/test_paged_attention.py::test_chunk_cache_lru_caps_and_counts_evictions`)
on the port's engine, the knob through the config and the schema, the
engine's `RTT_` env knobs against the JAX engine's `RT_` ones (bridged
params), greedy tokens across evictions, and a failed tick emptying the
cache.  The tests that compare with the JAX package import it inside a
fixture, so the file also runs where only torch is installed.

Card tests (marker `cuda`; tiny bf16 model, small engines): a replayed
chunk bit-equal to the eager chunk from one state (token rows, tokens,
positions, pools; bf16 and int8 KV), a width evicted and captured
again, a failed tick emptying the cache, K6's workspace unchanged
across captures, and the launch counters (L x chunk a replay, none at
capture).  On the chip:

    python -m pytest tests/test_torch_engine_graphs.py -m cuda -q

All draws seeded (RT008).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.config import LLMEngineConfig
from ray_tpu_torch.serve.llm_engine import ChunkGraph, LlamaEngine

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
def cpu_model():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32)
    return cfg, tllama.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def bridged():
    """The JAX engine's module and tiny f32 model, and the same params
    bridged to the port."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as jllama
    from ray_tpu.serve import llm_engine as jengine
    from ray_tpu_torch.models.bridge import params_from_numpy

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jengine, jcfg, jparams, tcfg, tparams


def _generate(cfg, params, prompt, n, device):
    return tllama.generate(cfg, params, [prompt], n,
                           device=device)[0].tolist()


# ----------------------------------------------------------------------
# the LRU and its knob (CPU)
# ----------------------------------------------------------------------
def test_chunk_cache_lru_caps_and_counts_evictions(cpu_model):
    """The per-width chunk-stepper cache is LRU-bounded: building a
    third width under cap=2 evicts the least-recently-used entry and
    the counters surface in stats() (the reference's test, same widths
    and expectations)."""
    cfg, params = cpu_model
    eng = LlamaEngine(cfg, params, slots=2, chunk=2, block_size=8,
                      max_len=32, chunk_cache_cap=2, device="cpu")
    try:
        eng._chunk_step_for(1)
        eng._chunk_step_for(2)
        eng._chunk_step_for(1)  # refresh width 1 -> width 2 is LRU
        eng._chunk_step_for(3)  # evicts width 2
        assert set(eng._chunk_cache) == {1, 3}
        eng._chunk_step_for(2)  # rebuild: evicts width 1
        assert set(eng._chunk_cache) == {3, 2}
        s = eng.stats()
        assert s["chunk_cache_size"] == 2
        assert s["chunk_cache_evictions"] == 2
    finally:
        eng.shutdown()


def test_fresh_engine_reports_an_empty_chunk_cache(bridged):
    """The warm chunk runs outside the cache: a fresh engine reports
    size 0 and no eviction, as the reference's does."""
    jengine, jcfg, jparams, tcfg, tparams = bridged
    jeng = jengine.LlamaEngine(jcfg, jparams, decode_kernel="gather",
                               **SMALL)
    teng = LlamaEngine(tcfg, tparams, device="cpu", **SMALL)
    try:
        for s in (jeng.stats(), teng.stats()):
            assert s["chunk_cache_size"] == 0
            assert s["chunk_cache_evictions"] == 0
    finally:
        jeng.shutdown()
        teng.shutdown()


@pytest.mark.parametrize("cap", [0, -1, 1, 3])
def test_config_and_schema_take_the_knob_as_jax_does(bridged, cap):
    """`chunk_cache_cap` validates as the JAX package's: at least 1, in
    the config and the schema, and it rides `engine_kwargs()`."""
    from ray_tpu.serve import config as jconfig
    from ray_tpu.serve import schema as jschema
    from ray_tpu_torch.serve.schema import LLMEngineSchema

    outcomes = []
    for cfg_cls, schema_cls in ((LLMEngineConfig, LLMEngineSchema),
                                (jconfig.LLMEngineConfig,
                                 jschema.LLMEngineSchema)):
        got = []
        for make in (lambda: cfg_cls(chunk_cache_cap=cap).validate(),
                     lambda: schema_cls.model_validate(
                         {"chunk_cache_cap": cap}).to_config()):
            try:
                got.append(make().engine_kwargs()["chunk_cache_cap"])
            except ValueError:
                got.append("refused")
        outcomes.append(got)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == (["refused"] * 2 if cap < 1 else [cap, cap])


def test_schema_knob_builds_an_engine_with_that_cap(cpu_model):
    from ray_tpu_torch.serve.schema import LLMEngineSchema

    cfg, params = cpu_model
    kw = LLMEngineSchema(chunk_cache_cap=3, slots=2, chunk=2, block_size=8,
                         max_len=32).to_config().engine_kwargs()
    eng = LlamaEngine(cfg, params, device="cpu", **kw)
    try:
        assert eng._chunk_cache_cap == 3
        for w in (1, 2, 4, 8):
            eng._chunk_step_for(w)
        s = eng.stats()
        assert s["chunk_cache_size"] == 3 and s["chunk_cache_evictions"] == 1
    finally:
        eng.shutdown()


def test_tokens_equal_generate_while_cap_1_evicts(cpu_model):
    """Cap 1 with widths changing mid-run (short and long prompts in one
    batch, then alone): every width change evicts and rebuilds, and the
    greedy tokens still equal `generate`'s."""
    cfg, params = cpu_model
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (2, 30, 9, 45, 3, 17)]
    n_new = [12, 5, 15, 4, 9, 7]
    eng = LlamaEngine(cfg, params, slots=2, chunk=2, block_size=4,
                      max_len=64, chunk_cache_cap=1, device="cpu")
    try:
        outs = [f.result(timeout=120) for f in
                [eng.submit(p, n) for p, n in zip(prompts, n_new)]]
        outs += [eng.submit(p, n).result(timeout=120)
                 for p, n in zip(prompts[:2], n_new[:2])]
        s = eng.stats()
    finally:
        eng.shutdown()
    want = [_generate(cfg, params, p, n, "cpu")
            for p, n in zip(prompts + prompts[:2], n_new + n_new[:2])]
    assert outs == want
    assert s["chunk_cache_size"] == 1 and s["chunk_cache_evictions"] >= 3


def test_failed_tick_empties_the_cache_without_counting(cpu_model,
                                                       monkeypatch):
    cfg, params = cpu_model
    eng = LlamaEngine(cfg, params, device="cpu", **SMALL)
    try:
        first = eng.submit([1, 2, 3], 6).result(timeout=60)
        assert eng.stats()["chunk_cache_size"] >= 1
        real = eng._run_chunk

        def failing(tables):
            raise RuntimeError("injected chunk failure")

        monkeypatch.setattr(eng, "_run_chunk", failing)
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit([4, 5], 3).result(timeout=60)
        assert len(eng._chunk_cache) == 0
        assert eng._chunk_cache_evictions == 0
        monkeypatch.setattr(eng, "_run_chunk", real)
        assert eng.submit([1, 2, 3], 6).result(timeout=60) == first
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# the env knobs, against the JAX engine (CPU)
# ----------------------------------------------------------------------
KNOBS = {
    "defaults": {},
    "ttft_window": {"SERVE_TTFT_WINDOW_S": "1"},
    "tick_ring": {"ENGINE_TICK_RING": "3"},
    "trace": {"LLM_ENGINE_TRACE": "1"},
}


def _run_knobbed(engine, prompts, capsys):
    """Requests one at a time (so each engine ticks the same number of
    times); returns (stats, ticks, trace lines printed).  The stats are
    read after `shutdown` has joined the engine thread: a request's
    result is set inside the tick that harvests it, before that tick
    appends its ring entry, so a read right after the result may see
    the ring one entry short whenever the thread is descheduled between
    the two (as under a loaded parallel test run)."""
    try:
        for p in prompts:
            engine.submit(p, 9).result(timeout=120)
    finally:
        engine.shutdown()
    s = engine.stats()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("tick adm=")]
    return s, s["ticks"], lines


@pytest.mark.parametrize("case", list(KNOBS))
def test_env_knobs_match_the_jax_engine(bridged, monkeypatch, capsys, case):
    """`RTT_SERVE_TTFT_WINDOW_S`, `RTT_ENGINE_TICK_RING` and
    `RTT_LLM_ENGINE_TRACE` do to the port's engine what the `RT_` ones
    do to the JAX engine: the reported TTFT window, the tick ring's
    length after the same ticks, and the per-tick trace line.  The JAX
    module reads its trace switch at import, so that case sets its
    module constant."""
    jengine, jcfg, jparams, tcfg, tparams = bridged
    for name in ("SERVE_TTFT_WINDOW_S", "ENGINE_TICK_RING",
                 "LLM_ENGINE_TRACE"):
        for prefix in ("RT_", "RTT_"):
            monkeypatch.delenv(prefix + name, raising=False)
    for name, value in KNOBS[case].items():
        monkeypatch.setenv("RT_" + name, value)
        monkeypatch.setenv("RTT_" + name, value)
    monkeypatch.setattr(jengine, "_TRACE", case == "trace")
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3]]
    capsys.readouterr()
    js, jticks, jlines = _run_knobbed(
        jengine.LlamaEngine(jcfg, jparams, decode_kernel="gather", **SMALL),
        prompts, capsys)
    ts, tticks, tlines = _run_knobbed(
        LlamaEngine(tcfg, tparams, device="cpu", **SMALL), prompts, capsys)
    assert ts["ttft_window_s"] == js["ttft_window_s"] == (
        1.0 if case == "ttft_window" else 10.0)
    assert tticks == jticks >= 4
    assert len(ts["tick_ring"]) == len(js["tick_ring"]) == (
        3 if case == "tick_ring" else tticks)
    assert len(tlines) == len(jlines) == (tticks if case == "trace" else 0)
    for t, j in zip(tlines, jlines):
        # same fields in the same order; the phase times differ
        assert [f.split("=")[0] for f in t.split()] == \
            [f.split("=")[0] for f in j.split()]


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tllama.LlamaConfig.tiny(vocab_size=128)  # bf16 compute
    return dev, cfg, tllama.init_params(cfg, 0, device=dev, dtype=cfg.dtype)


_STATE = ("_k_pool", "_v_pool", "_k_scale", "_v_scale", "_tok", "_pos")


def _snapshot(eng):
    return {k: getattr(eng, k).clone() for k in _STATE
            if getattr(eng, k) is not None}


def _restore(eng, snap):
    for k, v in snap.items():
        getattr(eng, k).copy_(v)


def _mid_decode(eng, W, seed):
    """A decode state on an idle engine: random pool contents, every
    slot on W shuffled blocks at a random position, random tokens;
    returns the tables."""
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(seed)
    S, bs = eng.slots, eng.block_size
    for pool in (eng._k_pool, eng._v_pool):
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     device=eng.device, dtype=torch.int8))
        else:
            pool.copy_(torch.randn(pool.shape, generator=gen,
                                   device=eng.device))
    for sc in (eng._k_scale, eng._v_scale):
        if sc is not None:
            sc.copy_(torch.rand(sc.shape, generator=gen, device=eng.device)
                     / 64)
    blocks = torch.randperm(eng._pool.num_blocks - 1, generator=gen,
                            device=eng.device)[:S * W] + 1
    eng._pos.copy_(torch.randint(0, W * bs - eng.chunk, (S,), generator=gen,
                                 device=eng.device, dtype=torch.int32))
    eng._tok.copy_(torch.randint(0, eng.cfg.vocab_size, (S,), generator=gen,
                                 device=eng.device, dtype=torch.int32))
    return blocks.reshape(S, W).to(torch.int32)


def _engine(dev, cfg, params, **kw):
    return LlamaEngine(cfg, params, device=dev, **{**SMALL, **kw})


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_graph_replay_bit_equals_the_eager_chunk(cuda_model, kv_dtype):
    dev, cfg, params = cuda_model
    eng = _engine(dev, cfg, params, kv_dtype=kv_dtype)
    try:
        tables = _mid_decode(eng, 4, seed=1)
        snap = _snapshot(eng)
        rows = eng._run_chunk(tables).clone()
        want = _snapshot(eng)
        step = eng._chunk_step_for(4)
        assert isinstance(step, ChunkGraph)
        for _ in range(3):  # the eager + capture call, then two replays
            _restore(eng, snap)
            got_rows = step(tables).clone()
            torch.cuda.synchronize(dev)
            assert torch.equal(got_rows, rows)
            got = _snapshot(eng)
            for k in want:
                assert torch.equal(got[k], want[k]), k
        assert step.capture_ms > 0 and step.graph_bytes >= 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_evicted_width_captured_again_gives_the_same_tokens(cuda_model):
    dev, cfg, params = cuda_model
    eng = _engine(dev, cfg, params, chunk_cache_cap=1)
    try:
        tables = _mid_decode(eng, 2, seed=2)
        snap = _snapshot(eng)
        first = eng._chunk_step_for(2)
        first(tables)
        _restore(eng, snap)
        rows = first(tables).clone()  # a replay
        wide = _mid_decode(eng, 8, seed=3)
        eng._chunk_step_for(8)(wide)  # evicts width 2
        assert set(eng._chunk_cache) == {8}
        again = eng._chunk_step_for(2)
        assert again is not first
        _restore(eng, snap)
        again(tables)
        _restore(eng, snap)
        assert torch.equal(again(tables), rows)
        assert eng.stats()["chunk_cache_evictions"] == 2
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_failed_tick_empties_the_graphs_and_serves_on(cuda_model,
                                                      monkeypatch):
    dev, cfg, params = cuda_model
    eng = _engine(dev, cfg, params)
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        first = eng.submit(prompt, 10).result(timeout=300)
        assert eng.stats()["chunk_cache_size"] >= 1
        real = eng._chunk_step_for
        calls = {"n": 0}

        def failing(W):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected capture failure")
            return real(W)

        monkeypatch.setattr(eng, "_chunk_step_for", failing)
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit([7, 7, 7], 4).result(timeout=300)
        s = eng.stats()
        assert s["chunk_cache_size"] == 0 and s["chunk_cache_evictions"] == 0
        assert eng.submit(prompt, 10).result(timeout=300) == first
        assert eng.stats()["decode_fallback_dispatch_total"] == 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_captures_keep_k6_workspace_and_count_replays(cuda_model):
    """The engine sizes K6's workspace once for its widest table: no
    capture at any width replaces it.  A capture moves no launch
    counter; a replay moves the fused op's by L x chunk."""
    dev, cfg, params = cuda_model
    eng = _engine(dev, cfg, params)
    try:
        ws = pa.workspace_of(dev)
        per_chunk = cfg.n_layers * eng.chunk
        for W in (1, 2, 4, 8):
            tables = _mid_decode(eng, W, seed=W)
            step = eng._chunk_step_for(W)
            for fn in (pa.paged_append_decode_attention, pa.paged_kv_append,
                       pa.paged_decode_attention):
                fn.launches = 0
            step(tables)  # eager run (counted), then the capture (not)
            assert pa.paged_append_decode_attention.launches == per_chunk
            step(tables)
            step(tables)
            assert pa.paged_append_decode_attention.launches == 3 * per_chunk
            assert pa.paged_kv_append.launches == 0
            assert pa.paged_decode_attention.launches == 0
            assert step.launches == {"paged_append_decode_attention":
                                     per_chunk, "paged_kv_append": 0,
                                     "paged_decode_attention": 0}
            now = pa.workspace_of(dev)
            assert now[0] is ws[0] and now[1] is ws[1]
        assert eng._max_seq_blocks == 8
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_cap_1_recaptures_across_widths_like_cap_8(cuda_model):
    """Under cap 1 every width change evicts the only graph (so no
    graph holds the shared pool any more) and captures the next: the
    tokens equal those of a cap-8 engine, which keeps every width."""
    dev, cfg, params = cuda_model
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (2, 30, 9, 45, 3, 17)]
    outs, stats = {}, {}
    for cap in (1, 8):
        eng = _engine(dev, cfg, params, slots=2, chunk=2, block_size=4,
                      chunk_cache_cap=cap)
        try:
            outs[cap] = [eng.submit(p, 8).result(timeout=300)
                         for p in prompts + prompts[:2]]
            stats[cap] = eng.stats()
        finally:
            eng.shutdown()
    assert outs[1] == outs[8]
    assert stats[1]["chunk_cache_evictions"] >= 3
    assert stats[8]["chunk_cache_evictions"] == 0

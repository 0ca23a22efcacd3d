"""The port's compiled graphs (`ray_tpu_torch.dag`) and their channel's
tensor codec.

The JAX package's `tests/test_dag.py` scenarios run on a port cluster:
chain, multi-actor pipeline, fan-out / fan-in, multi-output, an error
reaching its ref, teardown, an unbounded source, the geometry knobs,
the ambient deadline, the metrics, a SIGKILLed stage's typed error and
the arena freed at teardown.  The actors are made inside `_actors` so
that they travel to the workers by value.

The codec is held against the JAX package's on the same seeded numpy
payloads (RT008): numpy batches encode to the same bytes in both
packages (bf16 from `ml_dtypes` included), and each package's
`parse_tensor_header` / `decode_tensors` reads the other's bytes (a
`jax.Array` arrives as a torch tensor, a torch tensor as a `jax.Array`).
torch tensors round-trip through a channel in their dtype, bf16 as its
raw 16 bits; a DTensor takes the pickle path; an entry written from a
CUDA tensor raises on a reader with no card.
"""

import os
import signal
import struct
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu.dag import channel as jchan  # noqa: E402
from ray_tpu_torch import exceptions as exc  # noqa: E402
from ray_tpu_torch.dag import InputNode, MultiOutputNode  # noqa: E402
from ray_tpu_torch.dag import channel as tchan  # noqa: E402

from test_torch_parallel import spawn  # noqa: E402


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=64, ignore_reinit_error=True)
    yield
    rt.shutdown()


def _actors():
    """The actor class, made here so that it is pickled by value (a
    worker need not import this test module)."""

    @rt.remote
    class Worker:
        def __init__(self, tag=""):
            self.tag = tag
            self.calls = 0

        def double(self, x):
            self.calls += 1
            return 2 * x

        def add(self, a, b):
            return a + b

        def fail_if_negative(self, x):
            if x < 0:
                raise ValueError(f"negative: {x}")
            return x

        def num_calls(self):
            return self.calls

        def slow(self, x):
            time.sleep(5)
            return x

        def pid(self):
            return os.getpid()

    return Worker


# ----------------------------------------------------------------------
# the reference's scenarios on the port's runtime
# ----------------------------------------------------------------------
def test_single_actor_chain(cluster):
    w = _actors().remote()
    with InputNode() as inp:
        dag = w.double.bind(w.double.bind(inp))
    c = dag.experimental_compile()
    try:
        assert c.execute(3).get() == 12
        assert c.execute(5).get() == 20
        # get(timeout=0) is a poll: an already-published result wins
        ref = c.execute(7)
        time.sleep(0.5)
        assert ref.get(timeout=0) == 28
    finally:
        c.teardown()


def test_multi_actor_pipeline_carries_tensors(cluster):
    Worker = _actors()
    a, b = Worker.remote(), Worker.remote()
    with InputNode() as inp:
        dag = b.double.bind(a.double.bind(inp))
    c = dag.experimental_compile()
    try:
        refs = [c.execute(i) for i in range(4)]  # pipelined in-flight
        assert [r.get() for r in refs] == [4 * i for i in range(4)]
        gen = torch.Generator().manual_seed(0)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            x = (torch.randn((3, 70), generator=gen) * 8).to(dt)
            y = c.execute(x).get()
            assert isinstance(y, torch.Tensor) and y.dtype == dt
            assert torch.equal(y, 4 * x)
    finally:
        c.teardown()


def test_fan_out_fan_in(cluster):
    Worker = _actors()
    a, b, j = Worker.remote(), Worker.remote(), Worker.remote()
    with InputNode() as inp:
        dag = j.add.bind(a.double.bind(inp), b.double.bind(inp))
    c = dag.experimental_compile()
    try:
        assert c.execute(7).get() == 28
    finally:
        c.teardown()


def test_multi_output(cluster):
    Worker = _actors()
    a, b = Worker.remote(), Worker.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([a.double.bind(inp), b.add.bind(inp, inp)])
    c = dag.experimental_compile()
    try:
        assert c.execute(5).get() == [10, 10]
    finally:
        c.teardown()


def test_error_propagates_to_ref(cluster):
    Worker = _actors()
    a, b = Worker.remote(), Worker.remote()
    with InputNode() as inp:
        dag = b.double.bind(a.fail_if_negative.bind(inp))
    c = dag.experimental_compile()
    try:
        assert c.execute(4).get() == 8
        with pytest.raises(ValueError, match="negative"):
            c.execute(-1).get()
        # the DAG stays usable after an error
        assert c.execute(6).get() == 12
    finally:
        c.teardown()


def test_teardown_releases_actor(cluster):
    w = _actors().remote()
    with InputNode() as inp:
        dag = w.double.bind(inp)
    c = dag.experimental_compile()
    assert c.execute(1).get() == 2
    c.teardown()
    # after teardown the resident loop exited; normal calls work again
    assert rt.get(w.num_calls.remote(), timeout=10) >= 1
    with pytest.raises(RuntimeError):
        c.execute(2)


def test_unbounded_source_rejected(cluster):
    w = _actors().remote()
    dag = w.double.bind(1)  # no InputNode anywhere
    with pytest.raises(ValueError, match="InputNode"):
        dag.experimental_compile()


def test_channel_geometry_knobs_validated(cluster):
    """RTT_DAG_RING_SLOTS / RTT_DAG_SLOT_BYTES are validated at channel
    creation, and per-channel overrides take effect."""
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    assert tchan.ring_geometry() == (cfg.dag_ring_slots, cfg.dag_slot_bytes)
    with pytest.raises(ValueError, match="RTT_DAG_RING_SLOTS"):
        tchan.Channel("bad_ring", ring_slots=1)
    with pytest.raises(ValueError, match="RTT_DAG_SLOT_BYTES"):
        tchan.Channel("bad_slot", slot_bytes=16)
    ch = tchan.Channel("small_geom", ring_slots=2, slot_bytes=4096)
    try:
        assert (ch.ring_slots, ch.slot_bytes) == (2, 4096)
        ch.write(123)
        assert ch.read(timeout_s=10) == 123
    finally:
        ch.destroy()


def test_ref_get_honors_ambient_deadline(cluster):
    from ray_tpu_torch.core.runtime import _ambient_deadline

    w = _actors().remote()
    with InputNode() as inp:
        dag = w.slow.bind(inp)
    c = dag.experimental_compile()
    token = _ambient_deadline.set(time.monotonic() + 0.8)
    try:
        ref = c.execute(1)
        t0 = time.perf_counter()
        with pytest.raises(exc.DeadlineExceededError):
            ref.get(timeout=30)  # ambient 0.8s is narrower: it wins
        assert time.perf_counter() - t0 < 10
    finally:
        _ambient_deadline.reset(token)
        c.teardown()


def _hist_count(hist) -> float:
    return sum(v for labels, v in hist._samples() if "__count__" in labels)


def test_dag_metrics_instrumented(cluster):
    from ray_tpu_torch.metrics import metric_defs as mdefs

    w = _actors().remote()
    with InputNode() as inp:
        dag = w.double.bind(inp)
    c = dag.experimental_compile()
    was = mdefs.enabled()
    mdefs.set_enabled(True)
    try:
        hist = mdefs.metric("rt_dag_channel_write_seconds")
        writes0 = _hist_count(hist)
        assert c.execute(2).get() == 4
        assert c.execute(3).get() == 6
        assert _hist_count(hist) >= writes0 + 2
        assert mdefs.metric("rt_dag_channel_ring_full_total")._type() == \
            "counter"
        assert mdefs.metric("rt_dag_execs_total")._type() == "counter"
    finally:
        mdefs.set_enabled(was)
        c.teardown()


def test_stage_actor_sigkill_propagates_typed_error(cluster):
    from ray_tpu_torch import shm as shm_mod
    from ray_tpu_torch.core.runtime import get_runtime

    Worker = _actors()
    a, b, c_ = Worker.remote(), Worker.remote(), Worker.remote()
    pid_b = rt.get(b.pid.remote(), timeout=30)
    store = get_runtime().store
    used_before = store.used
    with InputNode() as inp:
        dag = c_.double.bind(b.double.bind(a.double.bind(inp)))
    cd = dag.experimental_compile()
    try:
        assert cd.execute(1).get(timeout=60) == 8  # pipe is live
        os.kill(pid_b, signal.SIGKILL)
        ref = cd.execute(2)
        with pytest.raises(exc.ActorDiedError):
            ref.get(timeout=90)
    finally:
        cd.teardown()
    assert store.used <= used_before + 256 * 1024, (used_before, store.used)
    assert shm_mod.sweep_stale_segments() == []


def test_dag_teardown_frees_channel_arena(cluster):
    from ray_tpu_torch.core.runtime import get_runtime

    a = _actors().remote()
    store = get_runtime().store
    used_before = store.used
    for _ in range(3):
        with InputNode() as inp:
            dag = a.double.bind(inp)
        c = dag.experimental_compile()
        assert c.execute(1).get() == 2
        c.teardown()
    assert store.used <= used_before + 256 * 1024, (used_before, store.used)


# ----------------------------------------------------------------------
# the tensor codec against the JAX package's
# ----------------------------------------------------------------------
def _numpy_payloads():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    return [
        f,
        (f, rng.integers(-9, 9, (7,)).astype(np.int64)),
        [np.array([True, False, True]), f[::2].copy()],
        {"obs": f, "bf": f.astype(ml_dtypes.bfloat16),
         "i8": rng.integers(-128, 127, (4, 4)).astype(np.int8),
         "c": (f + 1j * f).astype(np.complex64),
         "empty": np.zeros((0, 3), np.float16),
         "scalar": np.full((), 2.5)},
    ]


def _joined(chunks):
    return b"".join(bytes(memoryview(c).cast("B")) for c in chunks)


@pytest.mark.parametrize("i", range(4))
def test_numpy_payloads_encode_to_the_same_bytes(i):
    value = _numpy_payloads()[i]
    extra = {"seq": i, "tag": "x"}
    jc, jn = jchan.encode_tensors(value, extra=extra)
    tc, tn = tchan.encode_tensors(value, extra=extra)
    assert jn == tn
    assert _joined(jc) == _joined(tc)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == ml_dtypes.bfloat16:
        a, b = a.view(np.uint16), b.view(np.uint16)
    np.testing.assert_array_equal(a, b)


def _as_numpy(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(t)


def _items(value):
    if isinstance(value, dict):
        return sorted(value.items())
    if isinstance(value, (tuple, list)):
        return list(enumerate(value))
    return [(0, value)]


@pytest.mark.parametrize("i", range(4))
def test_each_package_decodes_the_others_numpy_bytes(i):
    value = _numpy_payloads()[i]
    for enc, dec in ((jchan, tchan), (tchan, jchan)):
        payload = _joined(enc.encode_tensors(value, extra=[i])[0])
        got, extra = dec.decode_tensors(memoryview(payload))
        assert extra == [i] and type(got) is type(value)
        for (k, a), (k2, b) in zip(_items(got), _items(value)):
            assert k == k2
            assert isinstance(a, np.ndarray) and not a.flags.writeable
            _equal(a, b)


def test_jax_arrays_arrive_as_torch_tensors_and_back():
    rng = np.random.default_rng(1)
    host = {"f": rng.standard_normal((4, 6)).astype(np.float32),
            "bf": rng.standard_normal((9,)).astype(ml_dtypes.bfloat16),
            "i": rng.integers(0, 9, (2, 3)).astype(np.int32)}
    jvals = {k: jnp.asarray(v) for k, v in host.items()}
    payload = _joined(jchan.encode_tensors(jvals)[0])
    _, _, entries, _ = tchan.parse_tensor_header(memoryview(payload))
    assert all(e["is_torch"] and e["device"] == tchan.DEVICE_CPU
               for e in entries)
    got, _ = tchan.decode_tensors(memoryview(payload))
    assert set(got) == set(host)
    for k, t in got.items():
        assert isinstance(t, torch.Tensor)
        _equal(_as_numpy(t), host[k])
    assert got["bf"].dtype == torch.bfloat16
    back = _joined(tchan.encode_tensors(got)[0])
    assert back == payload  # the same bytes, framework byte included
    jgot, _ = jchan.decode_tensors(memoryview(back))
    for k, a in jgot.items():
        assert isinstance(a, jax.Array)
        _equal(np.asarray(a), host[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float16, torch.int64, torch.bool,
                                   torch.complex64, torch.uint8])
def test_torch_tensors_round_trip_in_their_dtype(dtype):
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn((5, 7), generator=gen) * 10).to(dtype)
    noncontig = x.t()
    for value in (x, (x, noncontig), {"a": noncontig, "b": x[1]}):
        chunks, total = tchan.encode_tensors(value, extra="e")
        payload = _joined(chunks)
        assert len(payload) == total
        got, extra = tchan.decode_tensors(memoryview(payload))
        assert extra == "e"
        for (_, a), (_, b) in zip(_items(got), _items(value)):
            assert a.dtype == dtype and torch.equal(a, b)
            a.add_(1) if dtype != torch.bool else a.logical_not_()  # owned


def test_torch_payloads_through_a_channel_spill_past_the_slot(cluster):
    ch = tchan.Channel("torch_roundtrip")
    try:
        big = torch.arange(300_000, dtype=torch.float32).bfloat16()
        small = {"f": torch.ones(3),
                 "i8": torch.tensor([-3, 4], dtype=torch.int8)}
        ch.write_tensors((big, big[:5]), extra={"seq": 7})
        (a, b), extra = ch.read_tensors(timeout_s=30)
        assert extra == {"seq": 7} and torch.equal(a, big)
        assert torch.equal(b, big[:5]) and a.dtype == torch.bfloat16
        ch.write(small)
        got = ch.read(timeout_s=10)
        assert all(torch.equal(got[k], v) for k, v in small.items())
        # fp8 and quantized tensors have no raw form here: the pickle
        # path carries them
        assert tchan.as_tensor_batch(
            torch.ones(4).to(torch.float8_e4m3fn)) is None
        q = torch.quantize_per_tensor(torch.arange(4.0), 0.5, 0, torch.qint8)
        assert tchan.as_tensor_batch([q, torch.ones(2)]) is None
        ch.write([q, torch.ones(2)])
        got = ch.read(timeout_s=10)
        assert torch.equal(got[0].dequantize(), q.dequantize())
    finally:
        ch.destroy()


def test_cuda_entry_raises_on_a_reader_without_a_card(monkeypatch):
    payload = bytearray(_joined(tchan.encode_tensors(
        {"x": torch.ones(4)})[0]))
    head = struct.calcsize("<BBBBHI")
    # the entry's device byte, as a writer on a card sets it
    assert payload[head + 3] == tchan.DEVICE_CPU
    payload[head + 3] = tchan.DEVICE_CUDA
    _, _, entries, _ = tchan.parse_tensor_header(memoryview(bytes(payload)))
    assert entries[0]["device"] == tchan.DEVICE_CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchan.decode_tensors(memoryview(bytes(payload)))
    # the JAX package reads the same bytes: the byte it leaves 0 is spare
    got, _ = jchan.decode_tensors(memoryview(bytes(payload)))
    np.testing.assert_array_equal(np.asarray(got["x"]), np.ones(4))


_DTENSOR_TASK = """
import numpy as np
import torch
from ray_tpu_torch.dag import channel
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel.mesh import dtensor

def run(rank, world, inp):
    mesh = MeshSpec(dp=world).build(device_type="cpu")
    full = torch.arange(8.0).reshape(4, 2)
    dt = dtensor().distribute_tensor(full, mesh, [dtensor().Shard(0)] +
                                     [dtensor().Replicate()] * 5)
    local = dt.to_local()
    ok = []
    ok.append(channel.as_tensor_batch(dt) is None)
    ok.append(channel.as_tensor_batch((dt, local)) is None)
    ok.append(channel.as_tensor_batch(local) is not None)
    try:
        channel.encode_tensors({"w": dt})
        ok.append(False)
    except TypeError:
        ok.append(True)
    return {"ok": np.array(ok)}
"""


def test_dtensor_takes_the_pickle_path(tmp_path):
    for out in spawn(_DTENSOR_TASK, 2, {}, tmp_path):
        assert out["ok"].all(), out["ok"]

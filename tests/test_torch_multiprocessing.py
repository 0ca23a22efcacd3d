"""The port's `util.multiprocessing.Pool` and joblib backend on the CPU:
the JAX package's `tests/test_multiprocessing.py` on a port cluster
(apply / map / imap surfaces, chunking, error propagation, the joblib
backend end to end), a pool whose workers hold a share of a card, and
`util.accelerators` with its GPU meanings (the counterpart of
`tests/test_accelerators.py::test_util_helpers`).

One module-scoped cluster of the port's runtime, which counts one card
(`num_gpus=1`), serves every case; the functions the pools run are
defined inside the cases, so workers import nothing of this module.
"""

import math

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util.multiprocessing import Pool


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=8, num_gpus=1, ignore_reinit_error=True)
    yield
    rt.shutdown()


def test_apply_and_async(cluster):
    def add(a, b):
        return a + b

    with Pool(2) as p:
        assert p.apply(add, (2, 3)) == 5
        r = p.apply_async(add, (10, 20))
        assert r.get(timeout=30) == 30
        assert r.ready() and r.successful()


def test_map_variants(cluster):
    def sq(x):
        return x * x

    def add(a, b):
        return a + b

    with Pool(3) as p:
        assert p.map(sq, range(20)) == [i * i for i in range(20)]
        assert p.starmap(add, [(1, 2), (3, 4)]) == [3, 7]
        r = p.map_async(sq, [5, 6])
        assert r.get(30) == [25, 36]


def test_imap_ordered_and_unordered(cluster):
    def sq(x):
        return x * x

    with Pool(2) as p:
        assert list(p.imap(sq, range(8), chunksize=2)) == [
            i * i for i in range(8)
        ]
        assert sorted(p.imap_unordered(sq, range(8), chunksize=3)) == sorted(
            i * i for i in range(8)
        )


def test_initializer_and_errors(cluster):
    from ray_tpu_torch.util.multiprocessing import TimeoutError

    def init(v):
        import os

        os.environ["POOL_INIT"] = str(v)

    def read_init(_):
        import os

        return os.environ.get("POOL_INIT")

    with Pool(2, initializer=init, initargs=(7,)) as p:
        assert p.map(read_init, [0, 1]) == ["7", "7"]

    def boom(x):
        raise RuntimeError("pool boom")

    def slow(x):
        import time

        time.sleep(x)
        return x

    with Pool(2) as p:
        r = p.apply_async(boom, (1,))
        with pytest.raises(Exception, match="pool boom"):
            r.get(30)
        with pytest.raises(TimeoutError):
            p.apply_async(slow, (3,)).get(timeout=0.1)
        with pytest.raises(ValueError):
            p.join()  # not closed yet
        p.close()
        p.join()


def test_joblib_backend(cluster):
    import joblib

    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with joblib.parallel_backend("ray", n_jobs=4):
        out = joblib.Parallel()(
            joblib.delayed(math.sqrt)(i * i) for i in range(32)
        )
    assert out == [float(i) for i in range(32)]


def test_gpu_pool_workers_share_the_card(cluster):
    """The chip phase's pool shape: two workers of half a card each land
    in distinct processes, both pinned to the node's one card, and read
    it through `util.accelerators`; `map`, `imap_unordered` and a callback's
    `apply_async` agree."""
    def probe(i):
        import os

        from ray_tpu_torch.util import accelerators

        return (i, os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                accelerators.get_current_process_visible_chip_ids(),
                accelerators.get_current_pod_name())

    seen = []
    with Pool(processes=2, ray_remote_args={"num_gpus": 0.5}) as p:
        mapped = p.map(probe, range(8), chunksize=2)
        unordered = list(p.imap_unordered(probe, range(8)))
        p.apply_async(probe, (8,), callback=seen.append).get(timeout=60)
    assert [m[0] for m in mapped] == list(range(8))
    assert sorted(u[0] for u in unordered) == list(range(8))
    assert seen and seen[0][0] == 8
    rows = mapped + unordered + seen
    assert len({r[1] for r in rows}) == 2  # two worker processes
    for _, _, visible, ids, pod in rows:
        # a share of a card pins that card: both workers name the one
        # card of the node, and the reading is the environment's
        assert visible == "0" and ids == ["0"], (visible, ids)
        assert pod is None


def test_util_accelerators_read_the_cards(monkeypatch):
    from ray_tpu_torch.core import accelerators as acc
    from ray_tpu_torch.util import accelerators as uacc

    # a GPU host is in no slice: the pod helpers answer as the
    # reference's do off a TPU host
    assert uacc.get_current_pod_name() is None
    assert uacc.get_current_pod_worker_count() is None
    monkeypatch.setenv(acc.VISIBLE_CHIPS_ENV, "2,5")
    assert uacc.get_current_process_visible_chip_ids() == ["2", "5"]
    monkeypatch.setenv(acc.NUM_CHIPS_ENV, "4")
    assert uacc.get_num_tpu_chips_on_node() == 4
    monkeypatch.delenv(acc.NUM_CHIPS_ENV)
    monkeypatch.setattr(acc, "_nvml_count", lambda: 8)
    assert uacc.get_num_tpu_chips_on_node() == 2  # capped by the env
    monkeypatch.delenv(acc.VISIBLE_CHIPS_ENV)
    assert uacc.get_current_process_visible_chip_ids() is None
    assert uacc.get_num_tpu_chips_on_node() == 8

"""Port parity: the host tier of `ray_tpu_torch.parallel.collectives`
(`CollectiveGroup`: the one-shot rendezvous exchange, the ring allreduce
past `_RING_MIN_BYTES`, allgather, broadcast, reducescatter, send /
recv) on the port's runtime, against the JAX package's group on its own
runtime with the same seeded inputs (RT008), and against numpy.  Each
runtime boots once for the module; every blocking call has a timeout.
"""

import numpy as np
import pytest

from ray_tpu.parallel import collectives as jcoll
from ray_tpu_torch.parallel import collectives as tcoll

GROUP_WORLD = 3
BIG = 300_000  # f32: 1.2 MB, above _RING_MIN_BYTES


def _group_inputs(rank):
    rng = np.random.default_rng(50 + rank)
    return (rng.standard_normal(8).astype(np.float32),
            rng.standard_normal(BIG).astype(np.float32),
            rng.integers(0, 100, BIG // 2).astype(np.int64))


class _Member:
    """One member of a host collective group; the same class runs on
    either runtime (`coll` is that runtime's collectives module)."""

    def __init__(self, rank, world, group, coll_module):
        import importlib

        self.rank = rank
        self.coll = importlib.import_module(coll_module)
        self.world, self.group = world, group

    def join(self):
        self.g = self.coll.init_collective_group(self.world, self.rank,
                                                 self.group)
        return True

    def ops(self):
        small, big, ints = _group_inputs(self.rank)
        g = self.g
        out = {
            "allreduce_small": g.allreduce(small),
            "allreduce_mean_big": g.allreduce(big, op="mean"),
            "allreduce_max_big": g.allreduce(big, op="max"),
            "allreduce_int_sum": g.allreduce(ints),
            "allgather": np.stack(g.allgather(small)),
            "broadcast": g.broadcast(small, src_rank=1),
            "reducescatter": g.reducescatter(small),
        }
        if self.rank == 0:
            g.send(small * 2, 2)
        if self.rank == 2:
            out["recv"] = g.recv(0)
        g.barrier()
        return out


def _run_group(rt, coll_module, name):
    cls = rt.remote(_Member)
    members = [cls.remote(r, GROUP_WORLD, name, coll_module)
               for r in range(GROUP_WORLD)]
    rt.get(members[0].join.remote(), timeout=60)
    rt.get([m.join.remote() for m in members[1:]], timeout=60)
    outs = rt.get([m.ops.remote() for m in members], timeout=120)
    for m in members:
        rt.kill(m)
    return outs


@pytest.fixture(scope="module")
def group_results():
    import ray_tpu as jrt

    import ray_tpu_torch as trt

    trt.init(num_workers=3, num_cpus=8, ignore_reinit_error=True)
    try:
        port = _run_group(trt, "ray_tpu_torch.util.collective", "pt")
    finally:
        trt.shutdown()
    jrt.init(num_workers=3, num_cpus=8, ignore_reinit_error=True)
    try:
        ref = _run_group(jrt, "ray_tpu.util.collective", "jx")
    finally:
        jrt.shutdown()
    return port, ref


@pytest.mark.parametrize("op", [
    "allreduce_small", "allreduce_mean_big", "allreduce_max_big",
    "allreduce_int_sum", "allgather", "broadcast", "reducescatter", "recv"])
def test_host_collective_group_matches_jax_and_numpy(group_results, op):
    """The port's CollectiveGroup (both the one-shot exchange and the
    ring past `_RING_MIN_BYTES`) gives what the JAX package's gives on
    the same inputs, bit for bit, and what numpy says it must."""
    port, ref = group_results
    ins = [_group_inputs(r) for r in range(GROUP_WORLD)]
    small = [i[0] for i in ins]
    want = {
        "allreduce_small": np.sum(small, 0),
        "allreduce_mean_big": np.mean([i[1] for i in ins], 0),
        "allreduce_max_big": np.max([i[1] for i in ins], 0),
        "allreduce_int_sum": np.sum([i[2] for i in ins], 0),
        "allgather": np.stack(small),
        "broadcast": small[1],
        "recv": small[0] * 2,
    }
    for r in range(GROUP_WORLD):
        if op not in port[r]:
            continue
        got = port[r][op]
        assert got.dtype == ref[r][op].dtype, op
        np.testing.assert_array_equal(got, ref[r][op], err_msg=op)
        if op == "reducescatter":
            exp = np.array_split(np.sum(small, 0), GROUP_WORLD)[r]
        else:
            exp = want[op]
        np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
    assert tcoll._RING_MIN_BYTES == jcoll._RING_MIN_BYTES
    assert BIG * 4 >= tcoll._RING_MIN_BYTES > 8 * 4

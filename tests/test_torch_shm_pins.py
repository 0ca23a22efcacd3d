"""The port's runtime keeps a fetched block's store pin while any view of
it lives.

`Runtime._deser_pinned` releases a get's pin from a finalizer.  numpy
sets a new view's base to the last array of its base chain, so a
finalizer on the returned array fired while a slice of it still read the
shared-memory buffer: the block became a spill candidate, and the daemon
spilled it and reused its memory under the slice.  In `scripts/perf.py`'s
storage-faults epoch (a sort of a dataset twice the object store, read
back in batches that slice its blocks) that read as rows lost,
duplicated or garbage (`test_torch_perf_rows.py::test_storage_faults_row`
read 799,998 of 800,000).  The pin now hangs on each array's view root
(`runtime._view_root`).  Both cases fail with the finalizer on the
returned arrays, as before the repair.
"""

import gc

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.runtime import get_runtime
from test_torch_waits import within

ROWS = 200_000


@pytest.fixture
def cluster():
    """A cluster a case: the second case's store holds nothing of the
    first's."""
    rt.init(num_workers=1, num_cpus=2, object_store_memory=4 << 20,
            _system_config={"metrics_http_port": -1})
    yield rt
    rt.shutdown()


def _fetched_block():
    """(a task's column block as this process fetched it, its ref)."""

    @rt.remote
    def make(n):
        return {"id": np.arange(n, dtype=np.int64)}

    ref = make.remote(ROWS)
    return within(60, lambda: rt.get(ref)), ref


def test_a_slice_keeps_its_blocks_pin(cluster):
    """With only a slice of the fetched block alive, the block is not a
    spill candidate; once the slice goes, it is."""
    store = get_runtime().store
    blk, ref = _fetched_block()
    assert ref.binary() not in store.spill_candidates(4096)
    tail = blk["id"][-3:]
    del blk
    gc.collect()
    assert ref.binary() not in store.spill_candidates(4096)
    del tail
    gc.collect()
    assert ref.binary() in store.spill_candidates(4096)


def test_a_slice_keeps_its_rows_under_store_pressure(cluster):
    """The last rows of a fetched block, held by a slice alone, read the
    same after the store fills with other objects (spilling what is
    unpinned and reusing its memory)."""
    blk, _ = _fetched_block()
    tail = blk["id"][-3:]
    del blk
    gc.collect()
    fillers = [within(60, lambda: rt.put(np.full(190_000, -1,
                                                 dtype=np.int64)))
               for _ in range(10)]
    np.testing.assert_array_equal(tail, np.arange(ROWS - 3, ROWS))
    del fillers

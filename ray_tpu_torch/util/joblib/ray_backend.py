"""The joblib ParallelBackend implementation.

Reference: `python/ray/util/joblib/ray_backend.py` RayBackend — extends
joblib's MultiprocessingBackend but builds the pool from
`ray_tpu_torch.util.multiprocessing.Pool`, so every batch runs as an actor
task and `n_jobs=-1` means "all cluster CPUs", not local cores.
"""

from __future__ import annotations

from joblib._parallel_backends import MultiprocessingBackend

import ray_tpu_torch as rt
from ray_tpu_torch.util.multiprocessing import Pool


class RayTpuBackend(MultiprocessingBackend):
    supports_timeout = True

    def effective_n_jobs(self, n_jobs):
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 in Parallel has no meaning")
        if not rt.is_started():
            rt.init()
        cluster_cpus = max(1, int(rt.cluster_resources().get("CPU", 1)))
        if n_jobs is None:
            return 1
        if n_jobs < 0:
            return max(cluster_cpus + 1 + n_jobs, 1)
        return n_jobs

    def configure(self, n_jobs=1, parallel=None, prefer=None, require=None,
                  **kwargs):
        n_jobs = self.effective_n_jobs(n_jobs)
        self.parallel = parallel
        self._pool = Pool(processes=n_jobs)
        return n_jobs

"""joblib backend over the actor runtime.

Reference: `python/ray/util/joblib/` — `register_ray()` registers a
joblib parallel backend whose pool workers are actors, so
scikit-learn-style `Parallel(n_jobs=...)` code fans out over the
cluster:

    from ray_tpu_torch.util.joblib import register_ray
    import joblib
    register_ray()
    with joblib.parallel_backend("ray"):
        results = joblib.Parallel()(joblib.delayed(f)(i) for i in ...)
"""

from __future__ import annotations


def register_ray():
    from joblib.parallel import register_parallel_backend

    from ray_tpu_torch.util.joblib.ray_backend import RayTpuBackend

    register_parallel_backend("ray", RayTpuBackend)


__all__ = ["register_ray"]

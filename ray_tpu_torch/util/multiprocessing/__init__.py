from ray_tpu_torch.util.multiprocessing.pool import AsyncResult, Pool, TimeoutError

__all__ = ["Pool", "AsyncResult", "TimeoutError"]

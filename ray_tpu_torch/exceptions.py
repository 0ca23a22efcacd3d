"""The exceptions the serve slice raises, copied from the JAX package's
hierarchy (`RayTpuError` -> `GetTimeoutError` ->
`DeadlineExceededError`; `RayTpuError` -> `BackPressureError`) so
callers catch the same types with the same attributes."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """A wait expired.  Carries the timeout that expired and, when
    known, the object id the caller was waiting on."""

    def __init__(self, message: str = "", timeout_s=None, object_id=None):
        super().__init__(message)
        self.timeout_s = timeout_s
        self.object_id = object_id


class DeadlineExceededError(GetTimeoutError):
    """An end-to-end deadline expired: the caller has given up, so the
    engine fails fast instead of spending work nobody waits for."""


class BackPressureError(RayTpuError):
    """The admission queue is full: the request was rejected at once
    instead of queueing without bound.  `retry_after_s` hints when
    capacity is expected to free; the hint is also embedded in the
    message text so it survives transports that keep only the text."""

    def __init__(self, message: str = "admission queue is full",
                 retry_after_s: float = 1.0):
        self.retry_after_s = max(0.0, float(retry_after_s))
        super().__init__(
            f"{message} [retry_after_s={self.retry_after_s:.3f}]"
        )

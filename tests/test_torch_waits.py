"""Limits for the waits of the port's tests, and their tests.

A port test that waits on the runtime (a trainer's or a tuner's `fit`,
a training loop over a runner fleet) runs the wait through `within`, so
a wait that never ends (a fleet, a trial or a worker that never gets
its resources) fails its own case instead of holding the whole run.

This module stays light on purpose: a task or actor built from a
function or class defined at a test module's top level is pickled by
reference, so every worker that runs it imports that test module and
everything it imports.  A helper here costs them nothing.
"""

import threading
import time

import pytest


def within(seconds: float, fn):
    """`fn()` on a daemon thread; fails if it outlives `seconds`, else
    returns its value or raises its exception."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # rtlint: disable=RT005 — re-raised
            out["error"] = e  # by the caller's thread below

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{fn} outlived its {seconds} s limit"
    if "error" in out:
        raise out["error"]
    return out["value"]


def bounded_fit(runner, seconds: float = 240.0):
    """`runner.fit()` (a trainer's or a tuner's) under `within`'s
    limit."""
    return within(seconds, runner.fit)


def test_within_returns_the_value_and_raises_the_error():
    assert within(5.0, lambda: 42) == 42
    with pytest.raises(KeyError, match="boom"):
        within(5.0, lambda: {}["boom"])


def test_within_fails_a_wait_that_outlives_its_limit():
    done = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="outlived its 0.2 s limit"):
        within(0.2, lambda: done.wait(30.0))
    assert time.monotonic() - t0 < 5.0
    done.set()

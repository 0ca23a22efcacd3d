"""The traffic generator: the same seed gives the same inputs, every
seed sends the same sizes in another order, and sizes stay in range."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from port_bench import traffic

MIX = {"kind": "requests", "clients": 4, "block": 8,
       "prompt_tokens": {"lo": 64, "hi": 1024, "dist": "log_uniform"},
       "output_tokens": {"lo": 16, "hi": 64, "dist": "uniform"}}


def take(seed, n=24, vocab=1000):
    return list(itertools.islice(traffic.requests(MIX, seed, vocab), n))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -5, 2**70])
def test_same_seed_same_requests(seed):
    a, b = take(seed), take(seed)
    assert [(r.prompt, r.max_new) for r in a] == \
        [(r.prompt, r.max_new) for r in b]


def test_seeds_differ_in_order_not_in_sizes():
    a, b = take(1), take(2)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    for k in range(0, 24, MIX["block"]):
        blk_a, blk_b = a[k:k + 8], b[k:k + 8]
        assert sorted(len(r.prompt) for r in blk_a) == \
            sorted(len(r.prompt) for r in blk_b)
        assert sorted(r.max_new for r in blk_a) == \
            sorted(r.max_new for r in blk_b)


def test_sizes_and_ids_in_range():
    reqs = take(3, n=64, vocab=50)
    for r in reqs:
        assert 64 <= len(r.prompt) <= 1024
        assert 16 <= r.max_new <= 64
        assert min(r.prompt) >= 0 and max(r.prompt) < 50
    assert [r.index for r in reqs] == list(range(64))


def test_grid_quantiles():
    g = traffic.grid({"lo": 1, "hi": 100, "dist": "log_uniform"}, 2)
    assert g == [round(100 ** 0.25), round(100 ** 0.75)]
    assert traffic.grid({"lo": 0, "hi": 10, "dist": "uniform"}, 5) == \
        [1, 3, 5, 7, 9]


@pytest.mark.parametrize("median,mean", [(1020, 1155), (129, 211),
                                         (13, 28)])
def test_fit_to_median_and_mean(median, mean):
    lo, hi = traffic.log_uniform_span(median, mean)
    assert np.sqrt(lo * hi) == pytest.approx(median)
    assert (hi - lo) / np.log(hi / lo) == pytest.approx(mean)
    g = traffic.grid({"median": median, "mean": mean}, 4096)
    assert np.median(g) == pytest.approx(median, rel=0.01)
    assert np.mean(g) == pytest.approx(mean, rel=0.01)


def test_wrong_kind_refused():
    with pytest.raises(ValueError):
        next(traffic.requests({"kind": "token_batches"}, 0, 10))
    with pytest.raises(ValueError):
        traffic.log_uniform_span(100, 90)
    assert np.all(np.diff(traffic.grid(MIX["prompt_tokens"], 8)) >= 0)

"""The one traffic generator: reads a mix's data file
(`port_bench/traffic/<name>.json`) and makes its requests from a seed.

A mix (`kind` "requests") sends prompts of uniform random ids over the
vocabulary, with prompt and output lengths from `prompt_tokens` /
`output_tokens`: `dist` "log_uniform" or "uniform" over [`lo`, `hi`],
or "log_uniform" given a trace's published `median` and `mean` instead
(the span [median / s, median * s] whose mean is that mean).  The lengths are a
stratified grid of `block` values (the distribution's quantiles at
(k + 0.5) / block), and every run of `block` consecutive requests
holds each grid value once, in an order drawn from the seed: two
seeds send the same work in another order, so the seed does not
change how much work a window holds.  `clients` requests stay in
flight (a closed loop).

A later mix is a new data file; it needs no code.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent


def load(name: str) -> Dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of one seed: any integer seed,
    negative or past 64 bits, maps to its own stream."""
    return np.random.default_rng([seed % (1 << 64), stream])


def log_uniform_span(median: float, mean: float) -> Tuple[float, float]:
    """(lo, hi) of the log-uniform distribution with this median and
    mean: lo = median / s, hi = median * s, where the mean over the
    median, (s - 1 / s) / (2 ln s), is solved for s by bisection."""
    ratio = mean / median
    if ratio <= 1.0:
        raise ValueError(f"a log-uniform mean exceeds its median "
                         f"({mean} <= {median})")
    lo_s, hi_s = 1.0 + 1e-9, 1e6
    for _ in range(200):
        s = (lo_s * hi_s) ** 0.5
        if (s - 1.0 / s) / (2.0 * np.log(s)) < ratio:
            lo_s = s
        else:
            hi_s = s
    s = (lo_s * hi_s) ** 0.5
    return median / s, median * s


def span(spec: Dict) -> Tuple[float, float]:
    """[lo, hi] of a length spec, given or fitted to `median` / `mean`."""
    if "median" in spec:
        if spec.get("dist", "log_uniform") != "log_uniform":
            raise ValueError("median / mean fit only a log-uniform spec")
        return log_uniform_span(float(spec["median"]), float(spec["mean"]))
    return float(spec["lo"]), float(spec["hi"])


def grid(spec: Dict, n: int) -> List[int]:
    """`n` lengths at the quantiles (k + 0.5) / n of `spec`'s
    distribution over [lo, hi]."""
    lo, hi = span(spec)
    q = (np.arange(n) + 0.5) / n
    if spec.get("dist", "log_uniform") == "log_uniform":
        vals = lo * (hi / lo) ** q
    elif spec["dist"] == "uniform":
        vals = lo + (hi - lo) * q
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(round(v)) for v in vals]


@dataclasses.dataclass
class Request:
    index: int
    prompt: List[int]
    max_new: int


def requests(mix: Dict, seed: int, vocab: int) -> Iterator[Request]:
    """The mix's request sequence for `seed`, without end."""
    if mix["kind"] != "requests":
        raise ValueError(f"mix kind {mix['kind']!r} is not 'requests'")
    block = int(mix["block"])
    prompts = grid(mix["prompt_tokens"], block)
    outputs = grid(mix["output_tokens"], block)
    rng = rng_for(seed, 1)
    i = 0
    while True:
        pp, po = rng.permutation(block), rng.permutation(block)
        for j in range(block):
            t = prompts[pp[j]]
            ids = rng.integers(0, vocab, t, dtype=np.int64).tolist()
            yield Request(i, ids, outputs[po[j]])
            i += 1

"""Search spaces and variant generation.

Reference: `tune/search/sample.py` (Domain/Float/Integer/Categorical),
`tune/search/basic_variant.py` (BasicVariantGenerator: grid expansion x
num_samples with random sampling), `tune/search/variant_generator.py`.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class Randint(Domain):
    low: int
    high: int  # exclusive

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class Quantized(Domain):
    inner: Domain
    q: float

    def sample(self, rng):
        v = self.inner.sample(rng)
        return round(v / self.q) * self.q


# -- public constructors (reference: `ray.tune.uniform` etc.) ----------
def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def choice(categories: List[Any]) -> Choice:
    return Choice(list(categories))


def quniform(low: float, high: float, q: float) -> Quantized:
    return Quantized(Uniform(low, high), q)


def sample_from(fn: Callable[[Dict], Any]) -> "SampleFrom":
    return SampleFrom(fn)


@dataclass
class SampleFrom(Domain):
    fn: Callable[[Dict], Any]

    def sample(self, rng):  # resolved against the config later
        raise NotImplementedError


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    """Reference: `ray.tune.grid_search` marker dict."""
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _walk(space: Dict[str, Any], path=()):
    """Yield (path, leaf) for every leaf, recursing into nested plain
    dicts (so `{"train_loop_config": {"lr": grid_search(...)}}` works,
    as in the reference's nested variant resolution)."""
    for k, v in space.items():
        p = path + (k,)
        if isinstance(v, dict) and not _is_grid(v):
            yield from _walk(v, p)
        else:
            yield p, v


def _set_in(cfg: Dict[str, Any], path, value):
    for k in path[:-1]:
        cfg = cfg.setdefault(k, {})
    cfg[path[-1]] = value


def generate_variants(
    param_space: Dict[str, Any],
    num_samples: int = 1,
    seed: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Cross-product of grid_search entries x num_samples random draws
    of Domain entries (reference BasicVariantGenerator semantics:
    num_samples multiplies the grid)."""
    rng = random.Random(seed)
    entries = list(_walk(param_space))
    grid_paths = [p for p, v in entries if _is_grid(v)]
    grid_values = [v["grid_search"] for p, v in entries if _is_grid(v)]
    variants: List[Dict[str, Any]] = []
    combos = list(itertools.product(*grid_values)) if grid_paths else [()]
    for _ in range(num_samples):
        for combo in combos:
            cfg: Dict[str, Any] = {}
            deferred = []
            for p, v in entries:
                if p in grid_paths:
                    _set_in(cfg, p, combo[grid_paths.index(p)])
                elif isinstance(v, SampleFrom):
                    deferred.append((p, v))
                elif isinstance(v, Domain):
                    _set_in(cfg, p, v.sample(rng))
                else:
                    _set_in(cfg, p, v)
            for p, v in deferred:
                _set_in(cfg, p, v.fn(cfg))
            variants.append(cfg)
    return variants


class Searcher:
    """Pluggable searcher seam (reference: `tune/search/searcher.py`).

    External search libraries plug in by implementing this interface
    and passing the instance as `Tuner(..., searcher=...)`:

    - `suggest(trial_id)` -> a config dict, or None when the search is
      exhausted (the controller stops creating trials).
    - `on_trial_complete(trial_id, result, error)` — terminal feedback.
    - `on_trial_result(trial_id, result)` — intermediate feedback on
      every reported result (multi-fidelity searchers like BOHB fit
      their model on partial-budget observations).
    - set `adaptive = True` to have the controller pull suggestions
      lazily as capacity frees (model-based searchers want results
      before suggesting more); leave False to enumerate up front.
    """

    adaptive = False

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None,
                          error: bool = False) -> None:
        pass

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        pass


class BasicVariantGenerator(Searcher):
    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._variants = generate_variants(param_space, num_samples, seed)
        self._i = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg

    def total(self) -> int:
        return len(self._variants)


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator, built in (the reference ships
    TPE through the HyperOpt/Optuna integrations — `tune/search/hyperopt/`,
    `tune/search/optuna/`; neither dependency exists in this image, so
    the algorithm is native).

    After `n_startup` random trials, observations split at the `gamma`
    quantile of the metric into good/rest; numeric params sample
    candidates from a Parzen (gaussian-kernel) estimate over the good
    points and keep the candidate maximizing the good/rest density
    ratio l(x)/g(x); categorical params sample from smoothed good-count
    weights.

    adaptive=True: the controller pulls suggestions lazily and feeds
    results back (suggestions made before any feedback are random).
    """

    adaptive = True

    def __init__(self, param_space: Dict[str, Any], *, metric: str,
                 mode: str = "max", num_samples: int = 32,
                 n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        assert mode in ("max", "min")
        self.space = param_space
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested = 0
        self._live: Dict[str, Dict[str, Any]] = {}
        self._observed: List[tuple] = []  # (config, score)
        for path, dom in _walk(param_space):
            if _is_grid(dom):
                raise ValueError(
                    f"TPESearcher does not accept grid_search at {path}; "
                    "use a Domain (uniform/loguniform/choice/...)"
                )

    # -- observation ---------------------------------------------------
    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        self._observed.append((cfg, v if self.mode == "max" else -v))

    # -- suggestion ----------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        if len(self._observed) < self.n_startup:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._live[trial_id] = cfg
        return cfg

    def _flat_space(self):
        """(path, domain) pairs over nested dicts (same walk as
        BasicVariantGenerator)."""
        return list(_walk(self.space))

    def _random_config(self) -> Dict[str, Any]:
        import copy

        cfg = copy.deepcopy(self.space)
        deferred = []
        for path, dom in self._flat_space():
            if isinstance(dom, SampleFrom):
                deferred.append((path, dom))  # resolve after all draws
            elif isinstance(dom, Domain):
                _set_in(cfg, path, dom.sample(self._rng))
            # non-Domain leaves are literals already present in cfg
        for path, dom in deferred:
            _set_in(cfg, path, dom.fn(cfg))
        return cfg

    def _split(self):
        ranked = sorted(self._observed, key=lambda p: -p[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        return ranked[:n_good], ranked[n_good:]

    def _tpe_config(self) -> Dict[str, Any]:
        import copy
        import math

        good, rest = self._split()
        cfg = copy.deepcopy(self.space)
        deferred = []
        for path, dom in self._flat_space():
            key = path  # tuple path into nested config dicts

            def _get(c, p=key):
                for part in p:
                    c = c[part]
                return c

            if not isinstance(dom, Domain):
                continue  # literal: already present in the copied cfg
            if not isinstance(dom, (Uniform, LogUniform, Randint, Choice)):
                # quantized/sample_from/custom: random draw (TPE fit
                # over these is not implemented); sample_from defers
                # until every other param is concrete
                if isinstance(dom, SampleFrom):
                    deferred.append((path, dom))
                else:
                    _set_in(cfg, path, dom.sample(self._rng))
                continue
            if isinstance(dom, Choice):
                # index-keyed weights: categories may be unhashable
                # (lists/dicts are legal Choice members)
                weights = [1.0] * len(dom.categories)  # +1 smoothing
                for g, _ in good:
                    try:
                        v = _get(g)
                    except (KeyError, TypeError):
                        continue
                    for ci, c in enumerate(dom.categories):
                        if c == v:
                            weights[ci] += 1.0
                            break
                total = sum(weights)
                r = self._rng.uniform(0, total)
                acc = 0.0
                for ci, w in enumerate(weights):
                    acc += w
                    if r <= acc:
                        _set_in(cfg, path, dom.categories[ci])
                        break
                continue
            # numeric: Parzen density ratio over log-space for LogUniform
            logspace = isinstance(dom, LogUniform)
            xform = math.log if logspace else (lambda x: x)
            inv = math.exp if logspace else (lambda x: x)
            def _maybe(g):
                try:
                    return xform(_get(g))
                except (KeyError, TypeError):
                    return None

            g_pts = [p for p in (_maybe(g) for g, _ in good) if p is not None]
            r_pts = [p for p in (_maybe(g) for g, _ in rest) if p is not None]
            if not g_pts:
                _set_in(cfg, path, dom.sample(self._rng))
                continue
            lo = xform(dom.low)
            hi = xform(dom.high)
            bw = max((hi - lo) / max(len(g_pts), 1) ** 0.5, 1e-6)

            def dens(x, pts):
                if not pts:
                    return 1.0 / (hi - lo)
                s = sum(
                    math.exp(-0.5 * ((x - p) / bw) ** 2) for p in pts
                )
                return s / (len(pts) * bw * math.sqrt(2 * math.pi)) + 1e-12

            best_x, best_ratio = None, -1.0
            for _ in range(self.n_candidates):
                center = self._rng.choice(g_pts)
                x = min(max(self._rng.gauss(center, bw), lo), hi)
                ratio = dens(x, g_pts) / dens(x, r_pts)
                if ratio > best_ratio:
                    best_x, best_ratio = x, ratio
            val = inv(best_x)
            if isinstance(dom, Randint):
                val = int(round(min(max(val, dom.low), dom.high - 1)))
            _set_in(cfg, path, val)
        for path, dom in deferred:
            _set_in(cfg, path, dom.fn(cfg))
        return cfg


class BOHBSearcher(TPESearcher):
    """BOHB's model-based config selection (reference:
    `tune/search/bohb/bohb_search.py` TuneBOHB, native here — the
    hpbandster dependency doesn't exist in this image).

    BOHB = HyperBand for budget allocation + a TPE/KDE model for
    picking configs.  The multi-fidelity rule: fit the density model on
    observations from the LARGEST budget that has at least `n_startup`
    of them (falling back to smaller budgets), so early low-budget
    results guide the search immediately and high-budget results take
    over as they accumulate.  Pair with `HyperBandForBOHB`.
    """

    def __init__(self, param_space: Dict[str, Any], *, metric: str,
                 mode: str = "max", num_samples: int = 32,
                 n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None,
                 time_attr: str = "training_iteration"):
        super().__init__(param_space, metric=metric, mode=mode,
                         num_samples=num_samples, n_startup=n_startup,
                         gamma=gamma, n_candidates=n_candidates,
                         seed=seed)
        self.time_attr = time_attr
        # budget -> [(config, score)] observations
        self._budget_obs: Dict[int, List[tuple]] = {}

    def _record(self, trial_id: str, result: Optional[Dict]) -> None:
        cfg = self._live.get(trial_id)
        if cfg is None or not result or self.metric not in result:
            return
        budget = int(result.get(self.time_attr, 0))
        v = float(result[self.metric])
        score = v if self.mode == "max" else -v
        self._budget_obs.setdefault(budget, []).append((cfg, score))

    def on_trial_result(self, trial_id, result):
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        # the final result already arrived via on_trial_result (the
        # controller feeds every result through it) — recording here
        # again would double the KDE mass of completed trials
        self._live.pop(trial_id, None)

    def _model_obs(self) -> List[tuple]:
        """Observations at the largest budget with >= n_startup points;
        else one observation per distinct config (cold start) — raw
        pooling would count a single trial's repeated intermediate
        reports toward n_startup and flip into model mode after one
        or two distinct configs."""
        for budget in sorted(self._budget_obs, reverse=True):
            obs = self._budget_obs[budget]
            if len(obs) >= self.n_startup:
                return obs
        latest: Dict[int, tuple] = {}
        for obs in self._budget_obs.values():
            for cfg, score in obs:
                latest[id(cfg)] = (cfg, score)
        return list(latest.values())

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        # swap the fidelity-selected observations into the TPE
        # machinery, then reuse the base suggest wholesale
        self._observed = self._model_obs()
        return super().suggest(trial_id)

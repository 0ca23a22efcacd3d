"""Trial schedulers: early stopping and population-based training.

Reference: `tune/schedulers/` — ASHA (`async_hyperband.py`), median
stopping (`median_stopping_rule.py`), PBT (`pbt.py`), FIFO.
Decisions: CONTINUE (keep going), STOP (terminate trial).
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]) -> None:
        pass

    def choose_exploit(self, trial, trials) -> Optional[Any]:
        """PBT hook: return a donor trial to exploit, or None."""
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous Successive Halving (reference:
    `schedulers/async_hyperband.py` AsyncHyperBandScheduler).

    Rungs at grace_period * reduction_factor^k up to max_t; at each rung
    a trial continues only if its metric is in the top 1/reduction_factor
    of results recorded at that rung so far.
    """

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        grace_period: int = 1,
        reduction_factor: int = 4,
        max_t: int = 100,
        time_attr: str = "training_iteration",
    ):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self.time_attr = time_attr
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> recorded metric values
        self._recorded: Dict[int, List[float]] = defaultdict(list)

    def _better(self, v: float) -> float:
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        if self.metric not in result:
            return CONTINUE
        v = self._better(float(result[self.metric]))
        if t >= self.max_t:
            return STOP
        for rung in self.rungs:
            if t >= rung and rung not in trial.rungs_passed:
                trial.rungs_passed.add(rung)
                trial.rung_values[rung] = v
                self._recorded[rung].append(v)
        # Re-evaluate the trial's LATEST rung against that rung's
        # *current* population: textbook ASHA decides only on rung
        # arrival, which under lockstep arrival (weakest first) never
        # culls; a deferred re-check keeps the asynchrony but recovers
        # the culling power of synchronous successive halving.  Only the
        # most recent rung is re-checked so an improving trial is judged
        # by its freshest snapshot, not a noisy early one.
        if trial.rung_values:
            rung = max(trial.rung_values)
            recorded = self._recorded[rung]
            if len(recorded) >= 2:
                k = max(1, math.ceil(len(recorded) / self.rf))
                threshold = sorted(recorded, reverse=True)[k - 1]
                if trial.rung_values[rung] < threshold:
                    return STOP
        return CONTINUE


class HyperBandScheduler(TrialScheduler):
    """Bracketed HyperBand (reference: `schedulers/hyperband.py`
    HyperBandScheduler).

    The HyperBand idea over plain successive halving: run SEVERAL
    brackets in parallel, each trading off number-of-configs against
    per-config budget — bracket s starts trials with budget
    max_t / rf^s, so aggressive brackets kill early on little evidence
    while conservative ones give every config the full budget.  Trials
    are assigned round-robin to brackets on first result.

    Simplification vs the reference: the controller here has no PAUSE
    state, so halving inside a bracket is asynchronous (ASHA-style
    re-check against the rung's current population) rather than
    synchronized at rung boundaries.  Trials stop at max_t — budget
    exhausted is a stop, like the reference's bracket completion.
    """

    def __init__(self, metric: str, mode: str = "max", max_t: int = 81,
                 reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        self.time_attr = time_attr
        # integer arithmetic: math.log floats truncate exact powers
        # (log(243, 3) -> 4.999...), which would drop a bracket
        s, t = 0, max_t
        while t >= reduction_factor:
            t //= reduction_factor
            s += 1
        self.s_max = s
        # bracket s: rungs start at max_t / rf^s
        self._brackets: List[List[int]] = []
        for s in range(self.s_max + 1):
            r0 = max(1, int(max_t / (reduction_factor ** s)))
            rungs, t = [], r0
            while t < max_t:
                rungs.append(t)
                t *= reduction_factor
            self._brackets.append(rungs)
        self._next_bracket = 0
        self._assignment: Dict[Any, int] = {}
        # (bracket, rung) -> recorded values
        self._recorded: Dict[tuple, List[float]] = defaultdict(list)

    def _better(self, v: float) -> float:
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        if self.metric not in result:
            return CONTINUE
        t = result.get(self.time_attr, 0)
        v = self._better(float(result[self.metric]))
        b = self._assignment.get(trial.trial_id)
        if b is None:
            # most-exploratory bracket first, like the reference fills
            # bracket s_max down to 0 — surplus trials (count not
            # divisible by bracket count) land where culling is
            # cheapest, not in the never-culled full-budget bracket
            b = self._assignment[trial.trial_id] = (
                self.s_max - self._next_bracket % (self.s_max + 1)
            )
            self._next_bracket += 1
        if t >= self.max_t:
            return STOP
        for rung in self._brackets[b]:
            if t >= rung and rung not in trial.rungs_passed:
                trial.rungs_passed.add(rung)
                trial.rung_values[rung] = v
                self._recorded[(b, rung)].append(v)
        if trial.rung_values:
            rung = max(trial.rung_values)
            recorded = self._recorded[(b, rung)]
            if len(recorded) >= 2:
                k = max(1, math.ceil(len(recorded) / self.rf))
                threshold = sorted(recorded, reverse=True)[k - 1]
                if trial.rung_values[rung] < threshold:
                    return STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Reference: `schedulers/median_stopping_rule.py` — stop a trial
    whose best result is worse than the median of other trials' running
    averages at the same point."""

    def __init__(self, metric: str, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self._avgs: Dict[Any, List[float]] = defaultdict(list)

    def _better(self, v: float) -> float:
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        if self.metric not in result:
            return CONTINUE
        t = result.get(self.time_attr, 0)
        v = self._better(float(result[self.metric]))
        self._avgs[trial.trial_id].append(v)
        if t < self.grace or len(self._avgs) < self.min_samples:
            return CONTINUE
        others = [
            sum(vals) / len(vals)
            for tid, vals in self._avgs.items()
            if tid != trial.trial_id and vals
        ]
        if len(others) + 1 < self.min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        best = max(self._avgs[trial.trial_id])
        if best < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """Simplified PBT (reference: `schedulers/pbt.py`): every
    perturbation_interval iterations, bottom-quantile trials exploit a
    top-quantile donor (copy its checkpoint) and explore (perturb
    hyperparams by 1.2/0.8 or resample)."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        seed: Optional[int] = None,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._last: Dict[Any, float] = {}

    def _score(self, trial) -> Optional[float]:
        if trial.last_result is None or self.metric not in trial.last_result:
            return None
        v = float(trial.last_result[self.metric])
        return v if self.mode == "max" else -v

    def choose_exploit(self, trial, trials) -> Optional[Any]:
        t = (trial.last_result or {}).get(self.time_attr, 0)
        if t == 0 or t % self.interval != 0:
            return None
        scored = [(self._score(x), x) for x in trials]
        scored = [(s, x) for s, x in scored if s is not None]
        if len(scored) < 2:
            return None
        scored.sort(key=lambda p: p[0])
        k = max(1, int(len(scored) * self.quantile))
        bottom = [x for _, x in scored[:k]]
        top = [x for _, x in scored[-k:]]
        if trial in bottom and trial not in top:
            return self._rng.choice(top)
        return None

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for k, spec in self.mutations.items():
            if isinstance(spec, list):
                out[k] = self._rng.choice(spec)
            elif isinstance(spec, Domain):
                out[k] = spec.sample(self._rng)
            elif callable(spec):
                out[k] = spec()
            elif isinstance(out.get(k), (int, float)):
                out[k] = out[k] * self._rng.choice([0.8, 1.2])
        return out


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant paired with the BOHB searcher (reference:
    `tune/schedulers/hb_bohb.py` HyperBandForBOHB): budget allocation
    is HyperBand's; config SELECTION comes from `BOHBSearcher`, which
    receives every intermediate result via the controller's
    `on_trial_result` feedback and fits its KDE on the largest budget
    with enough observations."""


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: `tune/schedulers/pb2.py`,
    Parker-Holder et al. 2020): PBT's exploit step, but explore picks
    new hyperparameters with a GP-UCB bandit fit on observed
    (hyperparams -> reward change) data instead of random perturbation
    — far more sample-efficient for small populations.

    `hyperparam_bounds`: {key: (low, high)} continuous ranges the
    bandit searches over (the reference's PB2 API takes the same).
    """

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_bounds: Optional[Dict[str, tuple]] = None,
        quantile_fraction: float = 0.25,
        seed: Optional[int] = None,
        time_attr: str = "training_iteration",
        ucb_kappa: float = 1.0,
        n_candidates: int = 64,
    ):
        super().__init__(
            metric, mode, perturbation_interval,
            hyperparam_mutations=None,
            quantile_fraction=quantile_fraction, seed=seed,
            time_attr=time_attr,
        )
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._keys = sorted(self.bounds)
        # GP dataset: (normalized hyperparam vector, reward delta)
        self._data: List[tuple] = []
        self._last_metric: Dict[Any, float] = {}

    # -- data collection ----------------------------------------------
    def _normalize(self, config: Dict[str, Any]) -> Optional[List[float]]:
        x = []
        for k in self._keys:
            v = config.get(k)
            if not isinstance(v, (int, float)):
                return None
            lo, hi = self.bounds[k]
            x.append((float(v) - lo) / max(hi - lo, 1e-12))
        return x

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        if self.metric in result and t and t % self.interval == 0:
            v = float(result[self.metric])
            if self.mode == "min":
                v = -v
            prev = self._last_metric.get(trial.trial_id)
            self._last_metric[trial.trial_id] = v
            if prev is not None:
                x = self._normalize(trial.config)
                if x is not None:
                    self._data.append((x, v - prev))
                    if len(self._data) > 256:  # bound the GP fit cost
                        self._data = self._data[-256:]
        return CONTINUE

    def choose_exploit(self, trial, trials):
        donor = super().choose_exploit(trial, trials)
        if donor is not None:
            # exploit resets the trial's lineage (it restarts from the
            # donor's checkpoint): the next delta must not span the
            # jump, or the GP learns post-exploit configs are golden
            self._last_metric.pop(trial.trial_id, None)
        return donor

    # -- GP-UCB explore ------------------------------------------------
    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        if len(self._data) < 4:
            # cold start: uniform draw inside the bounds
            for k, (lo, hi) in self.bounds.items():
                out[k] = self._rng.uniform(lo, hi)
            return out
        X = np.asarray([x for x, _ in self._data])
        y = np.asarray([d for _, d in self._data])
        y = (y - y.mean()) / (y.std() + 1e-8)
        ls = 0.3  # RBF length-scale on [0,1]-normalized inputs

        def rbf(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / ls**2)

        K = rbf(X, X) + 1e-3 * np.eye(len(X))
        try:
            L = np.linalg.cholesky(K)
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        except np.linalg.LinAlgError:
            for k, (lo, hi) in self.bounds.items():
                out[k] = self._rng.uniform(lo, hi)
            return out
        cand = np.asarray([
            [self._rng.random() for _ in self._keys]
            for _ in range(self.n_candidates)
        ])
        Ks = rbf(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(axis=0), 1e-12, None)
        ucb = mu + self.kappa * np.sqrt(var)
        best = cand[int(np.argmax(ucb))]
        for i, k in enumerate(self._keys):
            lo, hi = self.bounds[k]
            out[k] = lo + float(best[i]) * (hi - lo)
        return out

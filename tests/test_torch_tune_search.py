"""The port's searchers (`ray_tpu_torch.tune.search`) on the CPU: the
JAX package's TPE and BOHB cases of `tests/test_tune.py` on the port's
runtime, and both searchers' suggestions held to the JAX package's with
the same seed on the same scripted results.

One module-scoped cluster of the port's runtime serves both runs (each
starts an actor a trial: 40 and 32 of them).
"""

import pytest

import ray_tpu_torch as rt
from ray_tpu import tune as jtune
from ray_tpu_torch import train, tune
from ray_tpu_torch.tune import TuneConfig, Tuner
from test_torch_waits import bounded_fit


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=8, ignore_reinit_error=True)
    yield rt
    rt.shutdown()


def test_tpe_searcher_beats_random_on_quadratic(cluster, tmp_path):
    """Adaptive TPE concentrates samples near the optimum of
    f(x, y) = -(x-0.7)^2 - (y-0.2)^2."""
    from ray_tpu_torch.tune import TPESearcher

    def objective(config):
        score = -(config["x"] - 0.7) ** 2 - (config["y"] - 0.2) ** 2
        tune.report({"score": score})

    searcher = TPESearcher(
        {"x": tune.uniform(0, 1), "y": tune.uniform(0, 1)},
        metric="score", mode="max", num_samples=40, n_startup=8, seed=0,
    )
    results = bounded_fit(Tuner(
        objective,
        tune_config=TuneConfig(metric="score", mode="max",
                               search_alg=searcher, max_concurrent_trials=4),
        run_config=train.RunConfig(name="tpe", storage_path=str(tmp_path)),
    ))
    assert results.num_errors == 0
    scores = sorted(
        (r.metrics["score"] for r in results if "score" in (r.metrics or {})),
        reverse=True,
    )
    assert len(scores) == 40
    assert scores[0] > -0.01, scores[:5]
    assert scores[9] > -0.1, scores[:10]


def test_bohb_beats_startup_random_on_quadratic(cluster, tmp_path):
    """BOHB: HyperBandForBOHB budgets + the KDE searcher fed by
    intermediate results converges on the quadratic bowl."""
    from ray_tpu_torch.tune import BOHBSearcher, HyperBandForBOHB

    def objective(config):
        score = -(config["x"] - 0.7) ** 2 - (config["y"] - 0.2) ** 2
        for i in range(4):
            tune.report({"score": score, "training_iteration": i + 1})

    searcher = BOHBSearcher(
        {"x": tune.uniform(0, 1), "y": tune.uniform(0, 1)},
        metric="score", mode="max", num_samples=32, n_startup=6, seed=0,
    )
    results = bounded_fit(Tuner(
        objective,
        tune_config=TuneConfig(
            metric="score", mode="max", search_alg=searcher,
            scheduler=HyperBandForBOHB(metric="score", mode="max",
                                       max_t=4, reduction_factor=2),
            max_concurrent_trials=4,
        ),
        run_config=train.RunConfig(name="bohb", storage_path=str(tmp_path)),
    ))
    assert results.num_errors == 0
    scores = sorted(
        (r.metrics["score"] for r in results if "score" in (r.metrics or {})),
        reverse=True,
    )
    assert scores and scores[0] > -0.02, scores[:5]
    assert searcher._budget_obs and max(searcher._budget_obs) >= 1


def _objective(c):
    return -(c["x"] - 0.7) ** 2 - (c["y"] - 0.2) ** 2


@pytest.mark.parametrize("kind", ["tpe", "bohb"])
def test_searchers_suggest_what_jax_suggests(kind):
    """TPE and BOHB with the same seed, fed the same scripted results
    (BOHB its intermediate budgets too), suggest the same configs."""
    def run(t):
        cls = t.TPESearcher if kind == "tpe" else t.BOHBSearcher
        s = cls({"x": t.uniform(0, 1), "y": t.uniform(0, 1)},
                metric="score", mode="max", num_samples=24, n_startup=6,
                seed=3)
        out = []
        for i in range(24):
            c = s.suggest(f"t{i}")
            out.append(c)
            score = _objective(c)
            if kind == "bohb":
                for it in (1, 2):
                    s.on_trial_result(f"t{i}", {
                        "score": score - 0.1 / it,
                        "training_iteration": it})
            s.on_trial_complete(f"t{i}", {"score": score,
                                          "training_iteration": 4})
        return out

    assert run(tune) == run(jtune)

"""The port's tune library (`ray_tpu_torch.tune`) on the CPU: the JAX
package's `tests/test_tune.py` on the port's runtime (its trainer case
over a `CudaTrainer`; the TPE and BOHB cases are in
`test_torch_tune_search.py`), and the runtime-free parts (variant
generation, ASHA / HyperBand / median-stopping / PBT / PB2 decisions on
a scripted metric stream) held to the JAX package's with the same
seeds.

One module-scoped cluster of the port's runtime serves every case (the
JAX file starts one a test).
"""

import os
import random

import pytest

import ray_tpu_torch as rt
from ray_tpu import tune as jtune
from ray_tpu.tune import controller as jcontroller
from ray_tpu_torch import train, tune
from ray_tpu_torch.tune import (
    ASHAScheduler,
    PopulationBasedTraining,
    TuneConfig,
    Tuner,
)
from ray_tpu_torch.tune import controller as tcontroller


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=8, ignore_reinit_error=True)
    yield rt
    rt.shutdown()


# ----------------------------------------------------------------------
# the JAX package's tests/test_tune.py, on the port
# ----------------------------------------------------------------------
def test_generate_variants_grid_and_samples():
    from ray_tpu_torch.tune.search import generate_variants

    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0.0, 1.0),
        "bs": 32,
    }
    vs = generate_variants(space, num_samples=3, seed=0)
    assert len(vs) == 6  # 2 grid x 3 samples
    assert {v["lr"] for v in vs} == {0.1, 0.01}
    assert all(0.0 <= v["wd"] <= 1.0 for v in vs)
    assert all(v["bs"] == 32 for v in vs)

    assert tune.choice([1, 2, 3]).sample(random.Random(0)) in (1, 2, 3)
    assert 1 <= tune.randint(1, 5).sample(random.Random(0)) < 5
    lo = tune.loguniform(1e-4, 1e-1).sample(random.Random(0))
    assert 1e-4 <= lo <= 1e-1


def test_tuner_function_trainable(cluster, tmp_path):
    def objective(config):
        score = 0.0
        for i in range(4):
            score += config["lr"]
            tune.report({"score": score})

    results = Tuner(
        objective,
        param_space={"lr": tune.grid_search([1.0, 2.0, 3.0])},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=2),
        run_config=train.RunConfig(name="fn", storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 3
    assert results.num_errors == 0
    best = results.get_best_result()
    assert best.metrics["score"] == pytest.approx(12.0)
    assert best.metrics["config"]["lr"] == 3.0


def test_tuner_class_trainable_with_checkpoint(cluster, tmp_path):
    class Quad(tune.Trainable):
        def setup(self, config):
            self.x = config["x"]
            self.val = 0.0

        def step(self):
            self.val += self.x
            return {"val": self.val}

        def save_checkpoint(self, d):
            return {"val": self.val}

        def load_checkpoint(self, state):
            if isinstance(state, dict):
                self.val = state["val"]

    results = Tuner(
        Quad,
        param_space={"x": tune.grid_search([1.0, 5.0])},
        tune_config=TuneConfig(metric="val", mode="max",
                               checkpoint_frequency=2),
        run_config=train.RunConfig(
            name="cls", storage_path=str(tmp_path),
            stop={"training_iteration": 4}
        ),
    ).fit()
    assert results.num_errors == 0
    best = results.get_best_result()
    assert best.metrics["val"] == pytest.approx(20.0)
    assert best.checkpoint is not None
    assert best.checkpoint.to_dict()["val"] == pytest.approx(20.0)


def test_asha_stops_bad_trials(cluster, tmp_path):
    def objective(config):
        import time as _t

        for i in range(16):
            _t.sleep(0.15)  # in-flight long enough for culling decisions
            tune.report({"acc": config["q"] * (i + 1)})

    results = Tuner(
        objective,
        param_space={"q": tune.grid_search([0.1, 0.2, 0.9, 1.0])},
        tune_config=TuneConfig(
            metric="acc",
            mode="max",
            scheduler=ASHAScheduler(
                metric="acc", mode="max", grace_period=2,
                reduction_factor=2, max_t=16,
            ),
            max_concurrent_trials=4,
        ),
        run_config=train.RunConfig(name="asha", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    iters = {
        r.metrics["config"]["q"]: r.metrics.get("training_iteration", 0)
        for r in results
    }
    # the best trial ran to max_t; at least one poor trial was culled
    assert max(iters.values()) >= 15
    assert min(iters.values()) < 15


def test_tuner_restore_resumes(cluster, tmp_path):
    marker = str(tmp_path / "crash_once")

    def objective(config):
        ck = tune.get_checkpoint()
        start = ck.to_dict()["i"] + 1 if ck else 0
        for i in range(start, 6):
            if (i == 3 and config["tag"] == "crashy"
                    and not os.path.exists(marker)):
                open(marker, "w").close()
                raise RuntimeError("boom")
            tune.report(
                {"i": i}, checkpoint=train.Checkpoint.from_dict({"i": i})
            )

    tuner = Tuner(
        objective,
        param_space={"tag": tune.grid_search(["ok", "crashy"])},
        tune_config=TuneConfig(metric="i", mode="max"),
        run_config=train.RunConfig(name="resume",
                                   storage_path=str(tmp_path)),
    )
    results = tuner.fit()
    assert results.num_errors == 1  # crashy failed

    restored = Tuner.restore(str(tmp_path / "resume"), objective).fit()
    assert restored.num_errors == 0
    for r in restored:
        assert r.metrics["i"] == 5


def test_pbt_exploits(cluster, tmp_path):
    def objective(config):
        v = 0.0
        for i in range(12):
            ck = tune.get_checkpoint()
            if i == 0 and ck is not None:
                v = ck.to_dict()["v"]
            v += config["lr"]
            tune.report(
                {"fitness": v}, checkpoint=train.Checkpoint.from_dict({"v": v})
            )

    results = Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.0, 1.0])},
        tune_config=TuneConfig(
            metric="fitness",
            mode="max",
            scheduler=PopulationBasedTraining(
                metric="fitness", mode="max", perturbation_interval=4,
                quantile_fraction=0.5, seed=0,
                hyperparam_mutations={"lr": [0.5, 1.0, 2.0]},
            ),
            max_concurrent_trials=2,
        ),
        run_config=train.RunConfig(name="pbt", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    # the lr=0 trial exploited the better trial at least once
    fits = sorted(r.metrics["fitness"] for r in results)
    assert fits[0] > 0.0


def test_tuner_over_cuda_trainer(cluster, tmp_path):
    """The JAX file's `test_tuner_over_jax_trainer`: a `CudaTrainer` on
    the CPU inside each trial, its `train_loop_config` from the param
    space, its inner reports forwarded to the trial."""
    def loop(config):
        m = 0.0
        for i in range(3):
            m += config["delta"]
            train.report({"m": m})

    trainer = train.CudaTrainer(
        loop, cuda_config=train.CudaConfig(device="cpu"),
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="inner",
                                   storage_path=str(tmp_path / "inner")),
    )
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "delta": tune.grid_search([1.0, 2.0])}},
        tune_config=TuneConfig(metric="m", mode="max",
                               resources_per_trial={"CPU": 0.5}),
        run_config=train.RunConfig(name="outer", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    assert results.get_best_result().metrics["m"] == pytest.approx(6.0)
    assert sorted(len(r.metrics_history) for r in results) == [3, 3]


def test_hyperband_brackets_and_culling(cluster, tmp_path):
    """HyperBand: brackets give different grace budgets; weak trials are
    culled, the best reaches max_t."""
    from ray_tpu_torch.tune import HyperBandScheduler

    def objective(config):
        import time as _t

        for i in range(9):
            _t.sleep(0.15)  # in-flight long enough for culling decisions
            tune.report({"acc": config["q"] * (i + 1)})

    results = Tuner(
        objective,
        param_space={"q": tune.grid_search([0.1, 0.2, 0.3, 0.9, 1.0])},
        tune_config=TuneConfig(
            metric="acc",
            mode="max",
            scheduler=HyperBandScheduler(
                metric="acc", mode="max", max_t=9, reduction_factor=3,
            ),
            max_concurrent_trials=5,
        ),
        run_config=train.RunConfig(name="hb", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    iters = [r.metrics.get("training_iteration", 0) for r in results]
    assert max(iters) >= 8  # someone ran (nearly) the full budget
    sched = HyperBandScheduler(metric="m", max_t=81, reduction_factor=3)
    assert sched.s_max == 4
    assert sched._brackets[0] == []  # s=0: full budget, no early rungs
    assert sched._brackets[4] == [1, 3, 9, 27]  # s=4: starts at 1


def test_pb2_explores_within_bounds_and_improves(cluster, tmp_path):
    """PB2: exploit copies a donor checkpoint like PBT; explore picks
    hyperparams from a GP-UCB bandit inside the declared bounds."""
    from ray_tpu_torch.tune import PB2

    def objective(config):
        v = 0.0
        for i in range(12):
            ck = tune.get_checkpoint()
            if i == 0 and ck is not None:
                v = ck.to_dict()["v"]
            v += config["lr"]
            tune.report(
                {"fitness": v},
                checkpoint=train.Checkpoint.from_dict({"v": v}),
            )

    pb2 = PB2(
        metric="fitness", mode="max", perturbation_interval=4,
        hyperparam_bounds={"lr": (0.0, 2.0)},
        quantile_fraction=0.5, seed=0,
    )
    results = Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.0, 0.1, 1.5])},
        tune_config=TuneConfig(metric="fitness", mode="max",
                               scheduler=pb2, max_concurrent_trials=3),
        run_config=train.RunConfig(name="pb2", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    fits = sorted(r.metrics["fitness"] for r in results)
    assert fits[0] > 0.0
    for r in results:
        assert 0.0 <= r.config["lr"] <= 2.0
    assert len(pb2._data) > 0


def test_pb2_gp_ucb_prefers_high_reward_region():
    """With data showing reward grows with lr, the GP-UCB explore picks
    a clearly high lr (not a uniform draw)."""
    from ray_tpu_torch.tune import PB2

    pb2 = PB2(metric="m", hyperparam_bounds={"lr": (0.0, 1.0)}, seed=1)
    for lr in [0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 0.9, 0.95]:
        pb2._data.append(([lr], lr))
    picks = [pb2.explore({"lr": 0.1})["lr"] for _ in range(8)]
    assert sum(p > 0.5 for p in picks) >= 6, picks


def test_custom_searcher_seam(cluster, tmp_path):
    """An external searcher implementing the Searcher ABC plugs in:
    suggest / on_trial_result / on_trial_complete all fire."""
    from ray_tpu_torch.tune.search import Searcher

    class MySearcher(Searcher):
        adaptive = True

        def __init__(self):
            self.suggested = 0
            self.results_seen = 0
            self.completed = 0

        def suggest(self, trial_id):
            if self.suggested >= 5:
                return None
            self.suggested += 1
            return {"x": self.suggested / 10.0}

        def on_trial_result(self, trial_id, result):
            self.results_seen += 1

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed += 1

    def objective(config):
        for i in range(2):
            tune.report({"score": config["x"]})

    s = MySearcher()
    results = Tuner(
        objective,
        tune_config=TuneConfig(metric="score", mode="max",
                               search_alg=s, max_concurrent_trials=2),
        run_config=train.RunConfig(name="seam", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    assert s.suggested == 5
    assert s.completed == 5
    assert s.results_seen >= 5


# ----------------------------------------------------------------------
# runtime-free parity with the JAX package, same seeds
# ----------------------------------------------------------------------
def _space(t):
    return {"lr": t.loguniform(1e-5, 1e-1), "wd": t.uniform(0.0, 0.3),
            "bs": t.choice([8, 16, 32]), "layers": t.randint(2, 9),
            "drop": t.quniform(0.0, 0.5, 0.1),
            "opt": t.grid_search(["adamw", "sgd"]),
            "nested": {"warmup": t.grid_search([0, 100]), "fixed": 7}}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_basic_variant_generator_matches_jax(seed):
    from ray_tpu.tune.search import BasicVariantGenerator as JGen
    from ray_tpu_torch.tune.search import BasicVariantGenerator as TGen

    def variants(gen):
        out = []
        while (v := gen.suggest(f"t{len(out)}")) is not None:
            out.append(v)
        return out

    got = variants(TGen(_space(tune), num_samples=3, seed=seed))
    want = variants(JGen(_space(jtune), num_samples=3, seed=seed))
    assert len(got) == 12 and got == want


def _stream(n_trials=6, iters=12, seed=0):
    """A scripted metric stream: each trial's metric grows at its own
    seeded rate with seeded noise; results arrive interleaved."""
    rng = random.Random(seed)
    rates = [rng.uniform(0.1, 1.0) for _ in range(n_trials)]
    events = []
    for it in range(1, iters + 1):
        order = list(range(n_trials))
        rng.shuffle(order)
        for t in order:
            events.append((t, it, rates[t] * it + rng.gauss(0, 0.05)))
    return events


def _decide(controller_mod, sched):
    """Feed the stream to a scheduler as the controller would; the
    sequence of its decisions, trial by trial."""
    trials = [controller_mod.Trial(trial_id=f"t{i}", config={})
              for i in range(6)]
    stopped, out = set(), []
    for t, it, v in _stream():
        if t in stopped:
            continue
        res = {"acc": v, "training_iteration": it}
        trials[t].last_result = res
        d = sched.on_trial_result(trials[t], res)
        out.append((t, it, d))
        if d == "STOP":
            stopped.add(t)
    return out


@pytest.mark.parametrize("name", ["asha", "hyperband", "median"])
def test_stopping_schedulers_decide_as_jax(name):
    def make(t):
        if name == "asha":
            return t.ASHAScheduler(metric="acc", mode="max", grace_period=2,
                                   reduction_factor=2, max_t=12)
        if name == "hyperband":
            return t.HyperBandScheduler(metric="acc", mode="max", max_t=12,
                                        reduction_factor=3)
        return t.MedianStoppingRule(metric="acc", mode="max",
                                    grace_period=2, min_samples_required=3)

    got, want = _decide(tcontroller, make(tune)), _decide(jcontroller,
                                                          make(jtune))
    assert got == want
    assert any(d == "STOP" for _, _, d in got)


@pytest.mark.parametrize("name", ["pbt", "pb2"])
def test_population_schedulers_decide_as_jax(name):
    """PBT / PB2 with the same seed on the same stream choose the same
    donors at each perturbation and explore to the same configs."""
    def run(t, controller_mod):
        if name == "pbt":
            sched = t.PopulationBasedTraining(
                metric="acc", mode="max", perturbation_interval=3,
                quantile_fraction=0.34, seed=5,
                hyperparam_mutations={"lr": [0.1, 0.5, 1.0],
                                      "wd": t.uniform(0.0, 0.1)})
        else:
            sched = t.PB2(metric="acc", mode="max",
                          perturbation_interval=3, quantile_fraction=0.34,
                          hyperparam_bounds={"lr": (0.0, 1.0)}, seed=5)
        trials = [controller_mod.Trial(trial_id=f"t{i}",
                                       config={"lr": 0.1 * (i + 1),
                                               "wd": 0.01})
                  for i in range(6)]
        out = []
        for t_i, it, v in _stream():
            tr = trials[t_i]
            res = {"acc": v, "training_iteration": it}
            tr.last_result = res
            sched.on_trial_result(tr, res)
            donor = sched.choose_exploit(tr, trials)
            if donor is not None:
                tr.config = sched.explore(dict(donor.config))
                out.append((t_i, it, donor.trial_id, tr.config))
        return out

    got, want = run(tune, tcontroller), run(jtune, jcontroller)
    assert got and got == want


# ----------------------------------------------------------------------
# the slice's tune path, tiny: a Tuner sweeping a dataset-fed trainer
# ----------------------------------------------------------------------
def test_tuner_sweeps_a_dataset_fed_cuda_trainer(cluster, tmp_path):
    """`Tuner(CudaTrainer(ingest_train_loop, datasets={"train": ds}))`
    over a grid of two learning rates, both trials at once, each a
    one-worker trainer on the CPU at `LlamaConfig.tiny` f32: both end
    TERMINATED, each records the lr its AdamW used, their adapters
    differ after step 1, each step-0 loss is the JAX package's `loss_fn`
    on the rows the trial got (params through `models/bridge.py`) at
    1e-5, and the best result is the trial with the lower last loss."""
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import ray_tpu_torch.data as rd
    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.scripts import train_llama_lora

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, (24, 17)).astype(np.int32)
    for f in range(2):
        np.savez(tmp_path / f"part{f}.npz", tokens=tokens[f * 12:(f + 1) * 12],
                 row_id=np.arange(f * 12, (f + 1) * 12, dtype=np.int64))
    ds = rd.read_numpy(str(tmp_path / "*.npz"))
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jl = jllama.init_lora(jcfg, jax.random.PRNGKey(1), rank=8)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    trainer = train.CudaTrainer(
        train_llama_lora.ingest_train_loop, datasets={"train": ds},
        cuda_config=train.CudaConfig(device="cpu"),
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="inner",
                                   storage_path=str(tmp_path / "inner")))
    lrs = [1e-3, 5e-2]
    grid = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search(lrs), "device": "cpu",
            "cfg": dataclasses.replace(
                tllama.LlamaConfig.tiny(vocab_size=128),
                dtype=torch.float32),
            "params": np_tree(jparams), "lora": np_tree(jl), "steps": 3,
            "batch": 2}},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=2,
                               resources_per_trial={"CPU": 0.5}),
        run_config=train.RunConfig(name="sweep", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0
    state = json.load(open(os.path.join(grid.experiment_path,
                                        "experiment_state.json")))
    assert [t["status"] for t in state["trials"]] == ["TERMINATED"] * 2
    hists = {}
    for res in grid:
        lr = res.metrics["config"]["train_loop_config"]["lr"]
        hists[lr] = res.metrics_history
        assert [m["step"] for m in res.metrics_history] == [1, 2, 3]
        assert all(m["lr"] == lr for m in res.metrics_history)
        first = res.metrics_history[0]
        want = float(jllama.loss_fn(jcfg, jparams,
                                    jnp.asarray(tokens[first["row_ids"]]),
                                    lora=jl))
        np.testing.assert_allclose(first["loss"], want, rtol=1e-5,
                                   atol=1e-5)
    assert sorted(hists) == lrs
    assert hists[lrs[0]][0]["digest"] != hists[lrs[1]][0]["digest"]
    best = grid.get_best_result("loss", "min")
    assert best.metrics["loss"] == min(h[-1]["loss"] for h in hists.values())

"""ray_tpu_torch.tune — hyperparameter tuning.

Reference surface: `ray.tune` (SURVEY §2.4 Ray Tune): Tuner over trial
actors, search spaces, ASHA/median-stop/PBT schedulers, experiment
checkpoint/resume.  Trainers integrate via `Tuner(JaxTrainer(...))`.
"""

from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    PB2,
    HyperBandForBOHB,
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BOHBSearcher,
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import FunctionTrainable, Trainable
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler",
    "HyperBandScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "FunctionTrainable",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "PB2",
    "HyperBandForBOHB",
    "BOHBSearcher",
    "Trainable",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "report",
    "sample_from",
    "uniform",
]

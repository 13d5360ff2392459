"""Early stopping: config-driven train-until-done — counterpart of
``deeplearning4j_tpu/earlystopping.py`` (copied, its imports rewritten).

Reference: ``deeplearning4j-nn/.../earlystopping/`` —
``EarlyStoppingConfiguration.java:45-71`` (builder: modelSaver, epoch/iteration
termination conditions, saveLastModel, evaluateEveryNEpochs, scoreCalculator),
``trainer/BaseEarlyStoppingTrainer.java:76-147`` (epoch loop: fit every batch,
check per-iteration conditions on model score, every-N-epochs compute the
validation score, track/save best model, check epoch conditions),
``termination/*.java``, ``saver/{InMemoryModelSaver,LocalFileModelSaver}.java``,
``scorecalc/DataSetLossCalculator.java``.

Works for both MultiLayerNetwork and ComputationGraph (anything exposing
``fit(DataSet)``, ``score``, ``save/load`` and ``clone``).
"""

from __future__ import annotations

import copy
import enum
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------

class IterationTerminationCondition:
    """Checked after every minibatch against the last minibatch score."""

    def initialize(self) -> None:  # pragma: no cover - trivial
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class EpochTerminationCondition:
    """Checked at the end of each (evaluated) epoch against validation score."""

    def initialize(self) -> None:  # pragma: no cover - trivial
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """≙ ``MaxEpochsTerminationCondition.java``."""

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when score hasn't improved (by > min_improvement) for
    ``patience`` epochs. ≙ ``ScoreImprovementEpochTerminationCondition.java``."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def initialize(self) -> None:
        self.best_score: Optional[float] = None
        self.epochs_since_improvement = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if self.best_score is None:
            self.best_score = score
            return False
        if self.best_score - score > self.min_improvement:
            self.best_score = score
            self.epochs_since_improvement = 0
            return False
        self.epochs_since_improvement += 1
        return self.epochs_since_improvement >= self.patience

    def __repr__(self):
        return (f"ScoreImprovementEpochTerminationCondition(patience="
                f"{self.patience}, minImprovement={self.min_improvement})")


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop as soon as the score drops below a target ("good enough").
    ≙ ``BestScoreEpochTerminationCondition.java``."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def terminate(self, epoch: int, score: float) -> bool:
        return score < self.best_expected_score

    def __repr__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Wall-clock cutoff. ≙ ``MaxTimeIterationTerminationCondition.java``."""

    def __init__(self, max_time_seconds: float):
        self.max_time_seconds = max_time_seconds
        self.start = time.time()

    def initialize(self) -> None:
        self.start = time.time()

    def terminate(self, last_score: float) -> bool:
        return (time.time() - self.start) > self.max_time_seconds

    def __repr__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_time_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate if score exceeds a ceiling (divergence guard).
    ≙ ``MaxScoreIterationTerminationCondition.java``."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """NaN/Inf guard. ≙ ``InvalidScoreIterationTerminationCondition.java``.

    Besides the classic last-score check, this condition watches the
    stability engine's device-side non-finite counter
    (``dl4j_nonfinite_steps_total``, resilience/stability.py): with the
    step guard on, a poisoned step keeps the params finite and the lazy
    score gauge may never be polled while NaN — the counter catches it
    anyway.  The baseline is taken at ``initialize()`` so only
    non-finite steps observed DURING this early-stopping run terminate
    it.  Counter harvest happens at the engine's ``check_every``
    boundaries (and at fit exit), so detection latency is bounded by
    that cadence.  The baseline is read when the condition is built, and
    again at ``initialize()``; it is never 0 by default (the reference
    compares against 0 when ``initialize()`` never ran, so a poisoned
    step earlier in the process ends any later run).

    ``component=`` narrows the watched counter children (the family is
    labeled per component: ``"MultiLayerNetwork"`` /
    ``"ComputationGraph"`` / the master names) — set it when OTHER
    stability-enabled runs share the process (an online pipeline, a side
    model), or their skipped steps would terminate this run too.  The
    default watches every component, which is correct for the common
    one-training-run-per-process deployment."""

    def __init__(self, component: Optional[str] = None):
        self.component = component
        self._baseline = self._nonfinite_total()

    def _nonfinite_total(self) -> float:
        from deeplearning4j_tpu_torch.observability import get_registry

        labels = {"component": self.component} if self.component else {}
        return get_registry().family_total("dl4j_nonfinite_steps_total",
                                           **labels)

    def initialize(self) -> None:
        self._baseline = self._nonfinite_total()

    def terminate(self, last_score: float) -> bool:
        if math.isnan(last_score) or math.isinf(last_score):
            return True
        return self._nonfinite_total() > self._baseline

    def __repr__(self):
        if self.component:
            return (f"InvalidScoreIterationTerminationCondition("
                    f"component={self.component!r})")
        return "InvalidScoreIterationTerminationCondition()"


# ---------------------------------------------------------------------------
# model savers
# ---------------------------------------------------------------------------

class EarlyStoppingModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """≙ ``saver/InMemoryModelSaver.java`` — keeps clones in RAM."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, net, score: float) -> None:
        self.best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self.latest = net.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """≙ ``saver/LocalFileModelSaver.java`` — bestModel.zip / latestModel.zip
    in a directory, restored through the model's own serializer onto the
    device of the net last saved (``cuda`` when none was)."""

    def __init__(self, directory: str, model_cls=None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._model_cls = model_cls
        self._device = None

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latestModel.zip")

    def _save_atomic(self, net, path: str) -> None:
        # stage + rename: a crash mid-write must never tear the PREVIOUS
        # best/latest model (the reference rewrites the zip in place)
        tmp = path + ".tmp"
        net.save(tmp)
        os.replace(tmp, path)

    def save_best_model(self, net, score: float) -> None:
        self._model_cls = self._model_cls or type(net)
        self._device = net.device
        self._save_atomic(net, self.best_path)

    def save_latest_model(self, net, score: float) -> None:
        self._model_cls = self._model_cls or type(net)
        self._device = net.device
        self._save_atomic(net, self.latest_path)

    def _load(self, path):
        if self._model_cls is not None:
            return self._model_cls.load(path, self._device)
        from deeplearning4j_tpu_torch.models import serialization

        return serialization.load_model(path, self._device)

    def get_best_model(self):
        if not os.path.exists(self.best_path):
            return None
        return self._load(self.best_path)

    def get_latest_model(self):
        if not os.path.exists(self.latest_path):
            return None
        return self._load(self.latest_path)


class CheckpointModelSaver(EarlyStoppingModelSaver):
    """Model saving routed through ``resilience.CheckpointManager``: every
    best/latest save commits atomically (tmp -> fsync -> rename + COMMIT)
    and retention is bounded to ``keep`` checkpoints per track — replacing
    ad-hoc ``save_checkpoint`` call sites that wrote non-atomically into a
    live directory and retained forever.  ``get_*_model`` restores into a
    clone of the last-saved net (params, updater state, RNG stream and
    iteration all come from the checkpoint), so a crash between epochs
    loses at most the uncommitted epoch."""

    def __init__(self, directory: str, keep: int = 2):
        from deeplearning4j_tpu_torch.resilience import CheckpointManager

        self.directory = directory
        # synchronous managers: an early-stopping epoch boundary is not a
        # hot loop, and the trainer reads the model back immediately
        self._best = CheckpointManager(
            os.path.join(directory, "best"), keep=keep, async_save=False,
            auto_resume=False)
        self._latest = CheckpointManager(
            os.path.join(directory, "latest"), keep=keep, async_save=False,
            auto_resume=False)
        self._template = None

    def save_best_model(self, net, score: float) -> None:
        self._template = net
        self._best.save(net, trigger="best")

    def save_latest_model(self, net, score: float) -> None:
        self._template = net
        self._latest.save(net, trigger="latest")

    def _restore_from(self, manager):
        if self._template is None or manager.latest() is None:
            return None
        model = self._template.clone()
        manager.restore(model)
        return model

    def get_best_model(self):
        return self._restore_from(self._best)

    def get_latest_model(self):
        return self._restore_from(self._latest)


# ---------------------------------------------------------------------------
# score calculators
# ---------------------------------------------------------------------------

class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a validation iterator.
    ≙ ``scorecalc/DataSetLossCalculator.java`` (average=True semantics)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        self.iterator.reset()
        total, n = 0.0, 0
        for ds in self.iterator:
            b = ds.num_examples()
            total += net.score(dataset=ds) * b
            n += b
        return total / n if self.average and n else total


# ---------------------------------------------------------------------------
# configuration / result / trainer
# ---------------------------------------------------------------------------

class TerminationReason(enum.Enum):
    ERROR = "Error"
    ITERATION_TERMINATION_CONDITION = "IterationTerminationCondition"
    EPOCH_TERMINATION_CONDITION = "EpochTerminationCondition"


@dataclass
class EarlyStoppingResult:
    """≙ ``EarlyStoppingResult.java``."""

    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: Dict[int, float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


@dataclass
class EarlyStoppingConfiguration:
    """≙ ``EarlyStoppingConfiguration.java`` builder fields."""

    model_saver: EarlyStoppingModelSaver = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(default_factory=list)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1
    score_calculator: Optional[ScoreCalculator] = None

    class Builder:
        def __init__(self):
            self._cfg = EarlyStoppingConfiguration()

        def model_saver(self, saver):
            self._cfg.model_saver = saver
            return self

        def epoch_termination_conditions(self, *conds):
            self._cfg.epoch_termination_conditions = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._cfg.iteration_termination_conditions = list(conds)
            return self

        def save_last_model(self, b: bool = True):
            self._cfg.save_last_model = b
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._cfg.evaluate_every_n_epochs = n
            return self

        def score_calculator(self, sc):
            self._cfg.score_calculator = sc
            return self

        def build(self):
            return self._cfg


class EarlyStoppingTrainer:
    """≙ ``trainer/BaseEarlyStoppingTrainer.java:76-147``: the epoch loop.

    Single implementation covers MLN and CG (reference has one subclass per
    facade; our facades share the fit/score/clone surface).
    """

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator,
                 listener: Optional[Any] = None):
        self.config = config
        self.net = net
        self.train = train_iterator
        self.listener = listener

    def _train_epoch(self, cfg):
        """One pass over the training iterator.  Returns (terminate, reason)
        from the iteration termination conditions."""
        for ds in self.train:
            if hasattr(ds, "features"):
                self.net.fit(ds.features, ds.labels,
                             fmask=getattr(ds, "features_mask", None),
                             lmask=getattr(ds, "labels_mask", None))
            else:
                x, y = ds[0], ds[1]
                self.net.fit(x, y)
            last_score = self.net.score_value
            for c in cfg.iteration_termination_conditions:
                if c.terminate(last_score):
                    return True, c
        return False, None

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        if self.listener is not None:
            self.listener.on_start(cfg, self.net)

        score_vs_epoch: Dict[int, float] = {}
        best_score = float("inf")
        best_epoch = -1
        epoch = 0
        while True:
            self.train.reset()
            terminate = False
            reason: Optional[IterationTerminationCondition] = None
            try:
                terminate, reason = self._train_epoch(cfg)
            except Exception as e:  # ≙ reference Error termination path
                result = EarlyStoppingResult(
                    TerminationReason.ERROR, repr(e), score_vs_epoch,
                    best_epoch, best_score, epoch,
                    cfg.model_saver.get_best_model())
                if self.listener is not None:
                    self.listener.on_completion(result)
                return result

            if terminate:
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, self.net.score_value)
                result = EarlyStoppingResult(
                    TerminationReason.ITERATION_TERMINATION_CONDITION,
                    repr(reason), score_vs_epoch, best_epoch, best_score,
                    epoch, cfg.model_saver.get_best_model())
                if self.listener is not None:
                    self.listener.on_completion(result)
                return result

            # every-N-epochs validation scoring; epoch termination conditions
            # are only checked on evaluated epochs so they never see a stale
            # or placeholder score (≙ evaluateEveryNEpochs gating in the
            # reference epoch loop)
            evaluate = (epoch == 0 or (epoch + 1) % cfg.evaluate_every_n_epochs == 0)
            score = 0.0
            if evaluate:
                if cfg.score_calculator is not None:
                    score = cfg.score_calculator.calculate_score(self.net)
                score_vs_epoch[epoch] = score
                if self.listener is not None:
                    self.listener.on_epoch(epoch, score, cfg, self.net)
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.net, score)
            if cfg.save_last_model:
                cfg.model_saver.save_latest_model(self.net, score)

            if evaluate:
                for c in cfg.epoch_termination_conditions:
                    if c.terminate(epoch, score):
                        result = EarlyStoppingResult(
                            TerminationReason.EPOCH_TERMINATION_CONDITION,
                            repr(c), score_vs_epoch, best_epoch, best_score,
                            epoch + 1, cfg.model_saver.get_best_model())
                        if self.listener is not None:
                            self.listener.on_completion(result)
                        return result
            epoch += 1


class EarlyStoppingListener:
    """≙ ``listener/EarlyStoppingListener.java`` hook surface."""

    def on_start(self, config, net) -> None:  # pragma: no cover - hook
        pass

    def on_epoch(self, epoch, score, config, net) -> None:  # pragma: no cover
        pass

    def on_completion(self, result) -> None:  # pragma: no cover - hook
        pass


class DistributedEarlyStoppingTrainer(EarlyStoppingTrainer):
    """Early stopping over mesh-distributed training.

    ≙ ``spark/dl4j-spark/.../earlystopping/BaseSparkEarlyStoppingTrainer.java``
    (fit an epoch through the Spark wrapper, score, check conditions) — here
    each epoch trains through the DistributedNetwork's TrainingMaster and the
    iteration conditions see the post-epoch score.
    """

    def __init__(self, config: EarlyStoppingConfiguration, dist_net,
                 train_iterator, listener: Optional[Any] = None):
        super().__init__(config, dist_net.net, train_iterator, listener)
        self.dist = dist_net

    def _train_epoch(self, cfg):
        self.dist.fit(self.train)
        last_score = self.net.score_value
        for c in cfg.iteration_termination_conditions:
            if c.terminate(last_score):
                return True, c
        return False, None

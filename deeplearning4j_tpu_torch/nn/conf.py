"""Config half of ``deeplearning4j_tpu/nn/conf.py``: the builder calls the
zoo makes, the global layer defaults (activation, weight init, l1/l2,
dropout) that ``.list()`` and ``.graph()`` push into layers left at their
class defaults, and ``MultiLayerConfiguration`` to and from the same JSON
document (the ``configuration.json`` of a zip).

The training policies (``stability``, ``introspection``, ``numerics``)
are carried in a config as plain dicts, so a reference config keeps them
through a round trip; the builder makes them from the policy dataclasses
(``TrainingStability``, ``TrainingIntrospection``, ``TrainingNumerics``,
copied from the reference with their checks).  The stability guard reads
its policy (``resilience/stability.py``), and so do the introspection
and numerics engines (``observability/introspection.py``,
``observability/numerics.py``).  With ``set_input_type`` the list builder
infers each layer's input size and inserts the input preprocessors
(``nn/preprocessors.py``) between layers, as the reference's
``ListBuilder.build`` does.  Every builder call makes the JSON the
reference's builder makes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.preprocessors import (
    Preprocessor, auto_preprocessor, preproc_from_dict,
)

_COMPUTE_DTYPES = (None, "bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class UpdaterConfig:
    """Updater hyperparameters (copied field for field from the reference,
    so the JSON round-trips; the updaters come with the training slice)."""

    name: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9
    rho: float = 0.95
    rmsprop_decay: float = 0.95
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    epsilon: float = 1e-8
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_policy_warmup_steps: float = 0.0
    lr_policy_min_fraction: float = 0.0
    weight_decay: float = 0.0
    lr_schedule: Optional[Dict[int, float]] = None
    momentum_schedule: Optional[Dict[int, float]] = None
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0

    def to_dict(self):
        d = dataclasses.asdict(self)
        for k in ("lr_schedule", "momentum_schedule"):
            if d[k]:
                d[k] = {str(i): v for i, v in d[k].items()}
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        for k in ("lr_schedule", "momentum_schedule"):
            if d.get(k):
                d[k] = {int(i): v for i, v in d[k].items()}
        return UpdaterConfig(**d)


@dataclasses.dataclass(frozen=True)
class TrainingStability:
    """Training-stability policy (reference ``nn/conf.py``): the
    non-finite step guard, loss scaling (``"none"``, ``"dynamic"`` or
    ``"static"``) and the divergence sentinel's thresholds."""

    skip_nonfinite: bool = True
    loss_scaling: str = "none"          # none | dynamic | static
    loss_scale: float = 2.0 ** 15
    loss_scale_factor: float = 2.0
    loss_scale_growth_interval: int = 200
    loss_scale_min: float = 1.0
    loss_scale_max: float = 2.0 ** 24
    check_every: int = 25
    spike_factor: float = 10.0
    spike_patience: int = 2
    nonfinite_streak: int = 4
    lr_backoff: float = 0.5
    rewind_cooldown_checks: int = 2
    poison_evict_after: int = 2

    def __post_init__(self):
        if self.loss_scaling not in ("none", "dynamic", "static"):
            raise ValueError(
                f"unsupported loss_scaling '{self.loss_scaling}' "
                "(use 'none', 'dynamic', or 'static')")
        if self.loss_scale <= 0 or self.loss_scale_min <= 0:
            raise ValueError("loss scales must be > 0")
        if self.loss_scale_factor <= 1.0:
            raise ValueError("loss_scale_factor must be > 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if not 0.0 < self.lr_backoff < 1.0:
            raise ValueError("lr_backoff must be in (0, 1)")

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return TrainingStability(**d)


@dataclasses.dataclass(frozen=True)
class TrainingIntrospection:
    """Training-introspection policy (reference ``nn/conf.py``): per-layer
    gradient, update and activation statistics; an activation is dead
    when ``|a| <= dead_eps``."""

    collect_activations: bool = True
    dead_eps: float = 0.0

    def __post_init__(self):
        if self.dead_eps < 0:
            raise ValueError(f"dead_eps must be >= 0, got {self.dead_eps}")

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return TrainingIntrospection(**d)


@dataclasses.dataclass(frozen=True)
class TrainingNumerics:
    """Precision-ledger policy (reference ``nn/conf.py``): per-layer
    dynamic-range statistics every ``interval`` steps, ``sample`` values
    a tensor (0: all), a format risky past ``absorb_threshold``."""

    collect_activations: bool = True
    absorb_threshold: float = 0.5
    sample: int = 1024
    interval: int = 10

    def __post_init__(self):
        if not 0.0 < self.absorb_threshold <= 1.0:
            raise ValueError("absorb_threshold must be in (0, 1], got "
                             f"{self.absorb_threshold}")
        if self.sample < 0:
            raise ValueError(f"sample must be >= 0, got {self.sample}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return TrainingNumerics(**d)


@dataclasses.dataclass(frozen=True)
class MultiLayerConfiguration:
    """Completed, immutable network config."""

    layers: Tuple[Layer, ...]
    # {layer index: the preprocessor applied to that layer's input}
    preprocessors: Dict[int, Preprocessor] = dataclasses.field(
        default_factory=dict)
    input_type: Optional[InputType] = None
    updater: UpdaterConfig = UpdaterConfig()
    seed: int = 12345
    optimization_algo: str = "stochastic_gradient_descent"
    num_iterations: int = 1
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False
    backprop: bool = True
    compute_dtype: Optional[str] = None
    stability: Optional[dict] = None
    introspection: Optional[dict] = None
    numerics: Optional[dict] = None

    def __post_init__(self):
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"unsupported compute_dtype '{self.compute_dtype}' "
                "(use 'bfloat16', 'float16', or None)")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format_version": 1,
            "layers": [l.to_dict() for l in self.layers],
            "preprocessors": {str(i): p.to_dict()
                              for i, p in self.preprocessors.items()},
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "updater": self.updater.to_dict(),
            "seed": self.seed,
            "optimization_algo": self.optimization_algo,
            "num_iterations": self.num_iterations,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "compute_dtype": self.compute_dtype,
            "stability": self.stability,
            "introspection": self.introspection,
            "numerics": self.numerics,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=tuple(layer_from_dict(ld) for ld in d["layers"]),
            preprocessors={int(i): preproc_from_dict(pd) for i, pd
                           in (d.get("preprocessors") or {}).items()},
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            updater=UpdaterConfig.from_dict(d["updater"]),
            seed=d["seed"],
            optimization_algo=d["optimization_algo"],
            num_iterations=d["num_iterations"],
            backprop_type=d["backprop_type"],
            tbptt_fwd_length=d["tbptt_fwd_length"],
            tbptt_back_length=d["tbptt_back_length"],
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True),
            compute_dtype=d.get("compute_dtype"),
            stability=d.get("stability"),
            introspection=d.get("introspection"),
            numerics=d.get("numerics"),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        """The JSON's content as YAML (reference ``nn/conf.py:325``)."""
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml

        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))


class ListBuilder:
    """Layer-stack builder."""

    def __init__(self, parent: "Builder"):
        self._parent = parent
        self._layers: List[Layer] = []
        self._preprocessors: Dict[int, Preprocessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._pretrain = False
        self._backprop = True
        self._compute_dtype: Optional[str] = None

    def compute_dtype(self, dtype: str) -> "ListBuilder":
        """Mixed precision: run the forward in ``dtype`` ("bfloat16");
        params stay float32."""
        if dtype not in ("bfloat16", "float16", "float32"):
            raise ValueError(f"unsupported compute dtype '{dtype}'")
        self._compute_dtype = None if dtype == "float32" else dtype
        return self

    def layer(self, layer: Layer,
              index: Optional[int] = None) -> "ListBuilder":
        if index is not None and index != len(self._layers):
            raise ValueError(f"layers must be added in order; expected "
                             f"{len(self._layers)}, got {index}")
        self._layers.append(layer)
        return self

    def input_preprocessor(self, index: int,
                           preproc: Preprocessor) -> "ListBuilder":
        """Apply ``preproc`` to the input of layer ``index`` (in place of
        the one ``build`` would choose)."""
        self._preprocessors[index] = preproc
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        """The network's input type: ``build`` infers each layer's input
        size from it and inserts the preprocessors the layers need."""
        self._input_type = t
        return self

    def backprop_type(self, kind: str, fwd_length: int = 20,
                      back_length: int = 20) -> "ListBuilder":
        """``"truncated_bptt"``: ``fit`` trains each sequence batch in
        windows of ``fwd_length`` timesteps (the reference reads only the
        forward length)."""
        self._backprop_type = kind
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def build(self) -> MultiLayerConfiguration:
        if not self._layers:
            raise ValueError("No layers added")
        layers: List[Layer] = []
        preprocessors = dict(self._preprocessors)
        p = self._parent
        cur = self._input_type
        for i, layer in enumerate(self._layers):
            layer = p._apply_global_defaults(layer)
            if layer.name is None:
                layer = layer.with_name(f"layer_{i}")
            if cur is not None:
                if i not in preprocessors:
                    pre = auto_preprocessor(cur, layer)
                    if pre is not None:
                        preprocessors[i] = pre
                if i in preprocessors:
                    cur = preprocessors[i].output_type(cur)
                layer = layer.setup(cur)
                cur = layer.output_type(cur)
            elif getattr(layer, "n_in", 0) is None:
                raise ValueError(
                    f"Layer {i} ({type(layer).__name__}) has no n_in and no "
                    "input_type was set for inference")
            layer.validate()    # after setup: checks see inferred sizes
            layers.append(layer)
        return MultiLayerConfiguration(
            layers=tuple(layers), preprocessors=preprocessors,
            input_type=self._input_type, updater=p._updater, seed=p._seed,
            optimization_algo=p._optimization_algo,
            num_iterations=p._num_iterations,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back, pretrain=self._pretrain,
            backprop=self._backprop, compute_dtype=self._compute_dtype,
            **p._policies())


class Builder:
    """Global-hyperparameter builder (the calls the zoo makes)."""

    def __init__(self):
        self._seed = 12345
        self._updater = UpdaterConfig()
        self._optimization_algo = "stochastic_gradient_descent"
        self._num_iterations = 1
        self._activation: Optional[str] = None
        self._weight_init: Optional[str] = None
        self._dist: Optional[dict] = None
        self._l1: Optional[float] = None
        self._l2: Optional[float] = None
        self._dropout: Optional[float] = None
        self._regularization = False
        self._stability: Optional[TrainingStability] = None
        self._introspection: Optional[TrainingIntrospection] = None
        self._numerics: Optional[TrainingNumerics] = None

    def seed(self, s: int) -> "Builder":
        self._seed = int(s)
        return self

    def updater(self, name: str, **kwargs) -> "Builder":
        self._updater = dataclasses.replace(self._updater, name=name.lower(),
                                            **kwargs)
        return self

    def learning_rate(self, lr: float) -> "Builder":
        self._updater = dataclasses.replace(self._updater, learning_rate=lr)
        return self

    def momentum(self, m: float) -> "Builder":
        self._updater = dataclasses.replace(self._updater, momentum=m)
        return self

    def lr_policy(self, policy: str, **kwargs) -> "Builder":
        """``policy`` with its parameters by their short names
        (``decay_rate``, ``steps``, ``power``, ``warmup_steps``,
        ``min_fraction``)."""
        kw = {"lr_policy": policy}
        kw.update({f"lr_policy_{k}": v for k, v in kwargs.items()})
        self._updater = dataclasses.replace(self._updater, **kw)
        return self

    def lr_schedule(self, schedule: Dict[int, float]) -> "Builder":
        self._updater = dataclasses.replace(
            self._updater, lr_policy="schedule", lr_schedule=dict(schedule))
        return self

    def gradient_normalization(self, kind: str,
                               threshold: float = 1.0) -> "Builder":
        self._updater = dataclasses.replace(
            self._updater, gradient_normalization=kind,
            gradient_normalization_threshold=threshold)
        return self

    @staticmethod
    def _policy(cls, what: str, policy, kwargs):
        """The reference's rule for a training policy: ``False`` or None
        (no kwargs) turns it off, an instance is taken (kwargs override
        its fields), ``True`` builds one from kwargs."""
        if policy is False or policy is None:
            if kwargs:
                raise ValueError(f"{what}(False) takes no kwargs")
            return None
        if isinstance(policy, cls):
            return dataclasses.replace(policy, **kwargs) if kwargs \
                else policy
        if policy is True:
            return cls(**kwargs)
        raise ValueError(f"{what} expects True/False/{cls.__name__}, got "
                         f"{policy!r}")

    def training_stability(self, policy=True, **kwargs) -> "Builder":
        """The stability guard's policy: ``fit`` guards every step inside
        its captured graph (``resilience/stability.py``)."""
        self._stability = self._policy(TrainingStability,
                                       "training_stability", policy, kwargs)
        return self

    def training_introspection(self, policy=True, **kwargs) -> "Builder":
        self._introspection = self._policy(
            TrainingIntrospection, "training_introspection", policy, kwargs)
        return self

    def training_numerics(self, policy=True, **kwargs) -> "Builder":
        self._numerics = self._policy(TrainingNumerics, "training_numerics",
                                      policy, kwargs)
        return self

    def _policies(self) -> Dict[str, Optional[dict]]:
        """The training policies as a config carries them (dicts)."""
        return {name: (p.to_dict() if p is not None else None)
                for name, p in (("stability", self._stability),
                                ("introspection", self._introspection),
                                ("numerics", self._numerics))}

    def optimization_algo(self, algo: str) -> "Builder":
        """The solver: ``"stochastic_gradient_descent"`` (the default) or
        a full-batch one (``"lbfgs"``, ``"conjugate_gradient"``,
        ``"line_gradient_descent"``), which ``fit`` runs once a batch
        through ``optimize/solvers.py``."""
        self._optimization_algo = algo.lower()
        return self

    def iterations(self, n: int) -> "Builder":
        self._num_iterations = n
        return self

    def activation(self, a: str) -> "Builder":
        self._activation = a
        return self

    def weight_init(self, w: str, dist=None) -> "Builder":
        """The global weight init; ``dist`` (a distribution or its dict)
        for ``"distribution"``."""
        self._weight_init = w
        self._dist = (dist.to_dict() if dist is not None
                      and hasattr(dist, "to_dict") else dist)
        return self

    def regularization(self, flag: bool) -> "Builder":
        self._regularization = flag
        return self

    def l1(self, v: float) -> "Builder":
        self._l1 = v
        return self

    def l2(self, v: float) -> "Builder":
        self._l2 = v
        return self

    def dropout(self, v: float) -> "Builder":
        self._dropout = v
        return self

    def list(self) -> ListBuilder:
        return ListBuilder(self)

    def graph(self):
        from deeplearning4j_tpu_torch.models.graph import GraphBuilder

        return GraphBuilder(self)

    def _apply_global_defaults(self, layer: Layer) -> Layer:
        """Push the builder's globals into the layer fields still at their
        class default (the reference's layerwise-override rule); l1 and l2
        only under ``regularization(True)``."""
        updates = {}
        for field, glob in (
                ("activation", self._activation),
                ("weight_init", self._weight_init),
                ("dist", self._dist),
                ("l1", self._l1 if self._regularization else None),
                ("l2", self._l2 if self._regularization else None),
                ("dropout", self._dropout)):
            if glob is None or not hasattr(layer, field):
                continue
            default = next(f.default for f in dataclasses.fields(layer)
                           if f.name == field)
            if getattr(layer, field) == default:
                updates[field] = glob
        return dataclasses.replace(layer, **updates) if updates else layer


class NeuralNetConfiguration:
    @staticmethod
    def builder() -> Builder:
        return Builder()

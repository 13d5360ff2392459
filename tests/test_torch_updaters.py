"""The port's updaters (``deeplearning4j_tpu_torch/optimize/updaters.py``)
and losses (``nn/losses.py``) against the JAX package's, on the same
numpy parameters, gradients, labels and pre-activations.

Tolerances: updates, state and params after three steps to
``atol=1e-6``; loss scores to ``atol=1e-5`` (float32, different
summation orders; the port evaluates schedules on the host in float64)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn.conf import UpdaterConfig as JUpdaterConfig
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.conf import UpdaterConfig
from deeplearning4j_tpu_torch.optimize import updaters as upd

ATOL = 1e-6

UPDATERS = ("sgd", "none", "nesterovs", "adagrad", "rmsprop", "adadelta",
            "adam", "adamw")
POLICIES = {
    "exponential": dict(lr_policy="exponential", lr_policy_decay_rate=0.9),
    "step": dict(lr_policy="step", lr_policy_decay_rate=0.5,
                 lr_policy_steps=2.0),
    "warmup_cosine": dict(lr_policy="warmup_cosine",
                          lr_policy_warmup_steps=2.0, lr_policy_steps=5.0,
                          lr_policy_min_fraction=0.1),
    "schedule": dict(lr_policy="schedule", lr_schedule={1: 0.05, 2: 0.02},
                     momentum_schedule={2: 0.5}),
}
NORMS = ("renormalize_l2_per_layer", "renormalize_l2_per_param_type",
         "clip_element_wise_absolute_value", "clip_l2_per_layer",
         "clip_l2_per_param_type")


def _tree(rng, scale=1.0):
    return {"layer_0": {"W": (rng.standard_normal((3, 4)) * scale)
                        .astype(np.float32),
                        "b": (rng.standard_normal(4) * scale)
                        .astype(np.float32)},
            "layer_1": {"sub0": {"gamma": (rng.standard_normal(4) * scale)
                                 .astype(np.float32)}}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _close(a, b, atol=ATOL):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], atol)
        return
    np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b),
                               atol=atol)


def _run_three_steps(**cfg_kw):
    jcfg = JUpdaterConfig(**cfg_kw)
    cfg = UpdaterConfig.from_dict(jcfg.to_dict())
    assert cfg == UpdaterConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp = _to(params, jnp.asarray)
    tp = _to(params, torch.tensor)
    jstate = jupd.init_state(jcfg, jp)
    tstate = upd.init_state(cfg, tp)
    overrides = {"layer_1": 0.03}
    for it in range(3):
        grads = _tree(rng, scale=3.0)
        jup, jstate = jupd.update(jcfg, _to(grads, jnp.asarray), jstate,
                                  float(it), overrides, params=jp)
        tup, tstate = upd.update(cfg, _to(grads, torch.tensor), tstate, it,
                                 overrides, params=tp)
        _close(tup, jup)
        _close(tstate, jstate)
        jp = {k: jupd.apply_updates(jp[k], jup[k]) for k in jp}
        _close(upd.apply_updates(tp, tup), jp)
        upd.apply_updates_(tp, tup)
        _close(tp, jp)


@pytest.mark.parametrize("name", UPDATERS)
def test_updater_matches_jax(name):
    _run_three_steps(name=name, learning_rate=0.1, weight_decay=0.01)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_lr_policy_matches_jax(policy):
    _run_three_steps(name="nesterovs", learning_rate=0.1, **POLICIES[policy])
    cfg = UpdaterConfig(learning_rate=0.1, **POLICIES[policy])
    jcfg = JUpdaterConfig(learning_rate=0.1, **POLICIES[policy])
    for it in range(7):
        np.testing.assert_allclose(upd.current_lr(cfg, it),
                                   float(jupd.current_lr(jcfg, it)),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", NORMS)
def test_gradient_normalization_matches_jax(kind):
    _run_three_steps(name="adam", learning_rate=0.01,
                     gradient_normalization=kind,
                     gradient_normalization_threshold=0.5)
    rng = np.random.default_rng(1)
    grads = _tree(rng, scale=2.0)
    jcfg = JUpdaterConfig(gradient_normalization=kind,
                          gradient_normalization_threshold=0.5)
    cfg = UpdaterConfig(**dataclasses.asdict(jcfg))
    _close(upd.normalize_tree(cfg, _to(grads, torch.tensor)),
           jupd.normalize_tree(jcfg, _to(grads, jnp.asarray)))


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="updater"):
        upd.init_state(UpdaterConfig(name="lion"), {})
    with pytest.raises(ValueError, match="lr policy"):
        upd.current_lr(UpdaterConfig(lr_policy="cyclic"), 0)
    with pytest.raises(ValueError, match="adamw"):
        upd.update(UpdaterConfig(name="adamw"), {}, {"m": {}, "v": {}}, 0)


# ---------------------------------------------------------------- losses
LOSSES = {
    # name: (activation, label kind)
    "mse": ("identity", "real"),
    "l1": ("tanh", "real"),
    "l2": ("identity", "real"),
    "xent": ("sigmoid", "binary"),
    "mcxent": ("softmax", "onehot"),
    "negativeloglikelihood": ("softmax", "onehot"),
    "kl_divergence": ("softmax", "dist"),
    "reconstruction_crossentropy": ("sigmoid", "binary"),
    "poisson": ("relu", "count"),
    "cosine_proximity": ("identity", "real"),
    "hinge": ("identity", "sign"),
    "squared_hinge": ("tanh", "sign"),
}


def _labels(rng, kind, shape):
    if kind == "real":
        return rng.standard_normal(shape)
    if kind == "binary":
        return (rng.random(shape) < 0.5).astype(float)
    if kind == "onehot":
        return np.eye(shape[-1])[rng.integers(0, shape[-1], shape[:-1])]
    if kind == "dist":
        p = rng.random(shape) + 0.1
        return p / p.sum(-1, keepdims=True)
    if kind == "count":
        return rng.integers(0, 4, shape).astype(float)
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, masked):
    activation, kind = LOSSES[name]
    rng = np.random.default_rng(sorted(LOSSES).index(name))
    shape = (3, 5, 6)
    labels = _labels(rng, kind, shape).astype(np.float32)
    pre = rng.standard_normal(shape).astype(np.float32)
    mask = ((rng.random(shape[:2]) < 0.7).astype(np.float32) if masked
            else None)
    want = jlosses.score(name, jnp.asarray(labels), jnp.asarray(pre),
                         activation,
                         None if mask is None else jnp.asarray(mask))
    got = losses.score(name, torch.from_numpy(labels), torch.from_numpy(pre),
                       activation,
                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    per = losses.score(name, torch.from_numpy(labels[:, 0]),
                       torch.from_numpy(pre[:, 0]), activation, mean=False)
    jper = jlosses.score(name, jnp.asarray(labels[:, 0]),
                         jnp.asarray(pre[:, 0]), activation, mean=False)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), atol=1e-5,
                               rtol=1e-5)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.get("focal")

"""The port's train path (``deeplearning4j_tpu_torch``): layers with
``train=True`` through the flash and fused-prologue seams, dropout,
``remat``, ``fit`` with Adam against the JAX package, updater state in
the zip, and float64 gradient checks.

On the CPU the seams run their kernels' plain versions through the same
``autograd.Function``s as on the card.  The JAX side takes its own seams
where a test says so (its helpers registered with ``allow_interpret``,
as its tests do).  Tolerances: layers at ``atol=1e-5``; training at
``rtol=1e-4, atol=1e-5`` on params and losses (float32, different
summation orders, compounded over steps)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import helpers as jhelpers
from deeplearning4j_tpu.helpers.flash_attention import (
    FlashAttentionHelper as JFlash,
)
from deeplearning4j_tpu.helpers.fused_epilogue import (
    FusedEpilogueHelper as JEpilogue,
)
from deeplearning4j_tpu.models.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.models.zoo import transformer_char_lm as jax_lm
from deeplearning4j_tpu.nn.layers import (
    LayerNorm as JLayerNorm,
    ResidualBlock as JResidualBlock, SelfAttentionLayer as JSelfAttention,
)
from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe
from deeplearning4j_tpu_torch.models import serialization, zoo
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.models.sequential import tree_leaves
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer, LayerNorm, OutputLayer, ResidualBlock, RnnOutputLayer,
    SelfAttentionLayer, layer_from_dict,
)

FIXTURES = Path(__file__).parent / "regression_fixtures"
ATOL = 1e-5
RTOL_FIT, ATOL_FIT = 1e-4, 1e-5
VOCAB = 29


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), requires_grad=grad)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def jax_seams(monkeypatch):
    """The JAX package's flash and epilogue helpers, allowed to run their
    Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setitem(jhelpers._registry, "attention",
                        JFlash(allow_interpret=True))
    monkeypatch.setitem(jhelpers._registry, "epilogue",
                        JEpilogue(allow_interpret=True))


def _grads_match(jlayer, params, x, g, **apply_kw):
    """Forward and grads (params and input) of the JAX layer and the port
    layer built from its dict, with ``train=True``."""
    def jfn(p, x):
        y, _ = jlayer.apply(p, {}, x, train=True, rng=None, **apply_kw)
        return y

    jy, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    layer = layer_from_dict(jlayer.to_dict())
    tp = _torch(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = layer.apply(tp, tx, train=True, rng=None)
    leaves = tree_leaves(tp)
    got = torch.autograd.grad(y, leaves + [tx], torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        # param grads sum over B*T rows: held relative to their largest
        # magnitude, as the flash tests hold the kernels' grads
        assert np.abs(a.numpy() - b).max() <= ATOL * max(np.abs(b).max(), 1)


def test_attention_through_the_flash_seam_matches_jax(jax_seams):
    jl = JSelfAttention(n_in=32, n_out=32, n_heads=4, n_kv_heads=2,
                        causal=True, rope=True)
    params = _np(jl.init(jax.random.PRNGKey(0), jnp.float32))
    before = fa.fwd_counts.plain_calls, fa.dq_counts.plain_calls
    _grads_match(jl, params, _x(1, 2, 128, 32), _x(2, 2, 128, 32))
    assert (fa.fwd_counts.plain_calls, fa.dq_counts.plain_calls) == (
        before[0] + 1, before[1] + 1)


def test_residual_block_through_the_prologue_seam_matches_jax(jax_seams):
    jl = JResidualBlock(layers=(
        JLayerNorm(n_in=32),
        JSelfAttention(n_in=32, n_out=32, n_heads=4, n_kv_heads=2,
                       causal=True, rope=True)))
    params = _np(jl.init(jax.random.PRNGKey(1), jnp.float32))
    params["sub0"] = {"gamma": _x(3, 32) + 1.0, "beta": _x(4, 32)}
    before = fe.counts.plain_calls, fa.fwd_counts.plain_calls
    _grads_match(jl, params, _x(5, 2, 128, 32) * 2 + 1, _x(6, 2, 128, 32))
    assert (fe.counts.plain_calls, fa.fwd_counts.plain_calls) == (
        before[0] + 1, before[1] + 1)


def test_padding_mask_takes_dot_product_attention_like_jax():
    jl = JSelfAttention(n_in=16, n_out=16, n_heads=4, causal=False)
    params = _np(jl.init(jax.random.PRNGKey(2), jnp.float32))
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    x = _x(7, 2, 5, 16)
    jy, _ = jl.apply(jax.tree_util.tree_map(jnp.asarray, params), {},
                     jnp.asarray(x), mask=jnp.asarray(mask))
    layer = layer_from_dict(jl.to_dict())
    before = fa.fwd_counts.plain_calls
    y = layer.apply(_torch(params), torch.from_numpy(x),
                    mask=torch.from_numpy(mask))
    assert fa.fwd_counts.plain_calls == before
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)


def _dropout_block(remat=False):
    return ResidualBlock(remat=remat, layers=(
        LayerNorm(n_in=16),
        DenseLayer(n_in=16, n_out=32, activation="relu", dropout=0.3),
        DenseLayer(n_in=32, n_out=16, activation="identity", dropout=0.2)))


def _block_params(block, seed=0):
    return block.init(torch.Generator().manual_seed(seed))


def test_fused_and_unfused_paths_draw_the_same_mask():
    block = _dropout_block()
    params = _block_params(block)
    x = torch.from_numpy(_x(8, 2, 6, 16))
    key = torch.Generator().manual_seed(77)
    before = fe.counts.plain_calls
    fused = block.apply(params, x, train=True, rng=key)
    assert fe.counts.plain_calls == before + 1
    helpers.enable_helpers(False)
    try:
        unfused = block.apply(params, x, train=True, rng=key)
    finally:
        helpers.enable_helpers(True)
    assert fe.counts.plain_calls == before + 1
    assert torch.equal(fused, unfused)
    assert not torch.equal(fused, block.apply(params, x, train=False))


def test_remat_grads_equal_plain_grads():
    x = torch.from_numpy(_x(9, 2, 6, 16))
    grads = []
    for remat in (False, True):
        block = _dropout_block(remat)
        params = _block_params(block, seed=3)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        y = block.apply(params, x, train=True,
                        rng=torch.Generator().manual_seed(5))
        grads.append(torch.autograd.grad((y * y).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def _small_lm():
    return jax_lm(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
                  layers=2)


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return params_from_numpy(conf, jax.device_get(jnet.params), device="cpu")


def _batch(seed, b=2, t=9):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)
    return ids, np.eye(VOCAB, dtype=np.float32)[np.roll(ids, -1, 1)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


def _params_close(port, jnet, steps):
    """Params equal the reference's after ``steps`` updates.  The key
    bias ``bk`` is the exception: softmax ignores a per-row shift, so its
    true gradient is 0 and Adam steps it by float noise (up to about the
    learning rate a step, with a sign the summation order picks); it is
    held to that bound instead."""
    got = tree_leaves(port.params)
    want = jax.tree_util.tree_leaves(jax.device_get(jnet.params))
    names = _paths(port.params)
    assert len(got) == len(want) == len(names)
    lr = port.conf.updater.learning_rate
    for name, a, b in zip(names, got, want):
        if name.endswith("/bk"):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 2 * lr * steps
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_FIT,
                                   atol=ATOL_FIT, err_msg=name)


def test_three_adam_steps_match_jax():
    jnet = _small_lm()
    net = _port_of(jnet)
    x, y = _batch(0)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=RTOL_FIT, atol=ATOL_FIT)
    assert net.iteration == jnet.iteration == 3
    _params_close(net, jnet, 3)
    np.testing.assert_allclose(net.score(x, y), float(jnet.score(x, y)),
                               rtol=RTOL_FIT, atol=ATOL_FIT)


def test_fit_over_batches_with_masks_matches_jax():
    jnet = _small_lm()
    net = _port_of(jnet)
    batches = []
    for s in range(2):
        x, y = _batch(10 + s)
        lm = np.ones(x.shape, np.float32)
        lm[0, -3:] = 0.0
        batches.append((x, y, None, lm))
    jnet.fit(batches, epochs=2)
    net.fit(batches, epochs=2)
    assert net.iteration == 4
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=RTOL_FIT, atol=ATOL_FIT)
    _params_close(net, jnet, 4)


def test_committed_zip_resumes_training_like_jax():
    """``transformer.zip`` carries Adam state at iteration 3; one more
    ``fit`` step from it equals the JAX package's."""
    path = FIXTURES / "transformer.zip"
    jnet = jax_restore(path)
    net = serialization.restore_multi_layer_network(path, device="cpu")
    assert net.iteration == jnet.iteration == 3
    jm = jax.tree_util.tree_leaves(jax.device_get(jnet.updater_state["m"]))
    assert len(tree_leaves(net.updater_state["m"])) == len(jm)
    ids = np.load(FIXTURES / "transformer_input.npy").astype(np.int32)
    vocab = net.layers[-1].n_out
    y = np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1) % vocab]
    jnet.fit(ids, y)
    net.fit(ids, y)
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=RTOL_FIT, atol=ATOL_FIT)
    _params_close(net, jnet, 4)


def test_port_zip_round_trips_updater_state(tmp_path):
    net = zoo.transformer_char_lm(vocab_size=VOCAB, d_model=16, n_heads=2,
                                  layers=1, device="cpu")
    x, y = _batch(1, t=5)
    net.fit(x, y)
    net.save(tmp_path / "m.zip")
    back = net.load(tmp_path / "m.zip", device="cpu")
    assert back.iteration == 1
    for slot in ("m", "v"):
        for a, b in zip(tree_leaves(net.updater_state[slot]),
                        tree_leaves(back.updater_state[slot])):
            assert torch.equal(a, b)
    net.fit(x, y)
    back.fit(x, y)
    for a, b in zip(tree_leaves(net.params), tree_leaves(back.params)):
        assert torch.equal(a, b)
    # the JAX package reads the port's zip, updater state included
    jnet = jax_restore(tmp_path / "m.zip")
    jm = jax.tree_util.tree_leaves(jax.device_get(jnet.updater_state["m"]))
    for a, b in zip(jm, tree_leaves(back.load(tmp_path / "m.zip",
                                              device="cpu")
                                    .updater_state["m"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_reserved_updater_subtrees_are_ignored(tmp_path):
    import io
    import zipfile

    net = zoo.transformer_char_lm(vocab_size=VOCAB, d_model=16, n_heads=2,
                                  layers=1, device="cpu")
    net.save(tmp_path / "m.zip")
    with zipfile.ZipFile(tmp_path / "m.zip") as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    state = dict(np.load(io.BytesIO(entries["updaterState.npz"])))
    state["__stability__/loss_scale"] = np.float32(4.0)
    state["__introspect__/steps"] = np.float32(1.0)
    buf = io.BytesIO()
    np.savez(buf, **state)
    entries["updaterState.npz"] = buf.getvalue()
    with zipfile.ZipFile(tmp_path / "r.zip", "w") as zf:
        for n, data in entries.items():
            zf.writestr(n, data)
    back = serialization.restore_multi_layer_network(tmp_path / "r.zip",
                                                     device="cpu")
    # the stability guard's subtree is carried across; the introspection
    # subtree is ignored (this net's configuration sets no such policy)
    assert set(back.updater_state) == {"m", "v", "__stability__"}
    assert float(back.updater_state["__stability__"]["loss_scale"]) == 4.0


def test_unported_training_engines_raise():
    """The three training engines that raised until they were ported
    (ROADMAP A9) now train the JAX zip's net: the stability guard, and
    since the online slice introspection and the numerics ledger, each
    leaving its state subtree on the net; an unknown policy key still
    raises, as the reference's policy dataclass does."""
    net = _port_of(_small_lm())
    x, y = _batch(2)
    for field, key in (("introspection", "__introspect__"),
                       ("numerics", "__numerics__")):
        net.conf = dataclasses.replace(net.conf, **{field: {"on": True}})
        with pytest.raises(TypeError, match="on"):
            net.fit(x, y)
        net.conf = dataclasses.replace(net.conf, **{field: {}})
        net.fit(x, y)
        assert key in net.updater_state
    net.conf = dataclasses.replace(net.conf, stability={})
    net.fit(x, y)
    assert "__stability__" in net.updater_state


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.transformer_char_lm(vocab_size=VOCAB, d_model=16, n_heads=2,
                                layers=1)


# ------------------------------------------------------ gradient checks
def _net(*layers):
    b = NeuralNetConfiguration.builder().seed(3).list()
    for layer in layers:
        b.layer(layer)
    return b.build()


GRADCHECK = {
    "dense": (lambda: _net(
        DenseLayer(n_in=4, n_out=5, activation="tanh", l2=0.01, l1=0.001),
        OutputLayer(n_in=5, n_out=3, activation="softmax",
                    loss="mcxent")), (3, 4)),
    "layer_norm": (lambda: _net(
        DenseLayer(n_in=4, n_out=6, activation="identity"),
        LayerNorm(n_in=6),
        OutputLayer(n_in=6, n_out=3, activation="identity",
                    loss="mse")), (3, 4)),
    "attention_gqa": (lambda: _net(
        SelfAttentionLayer(n_in=8, n_out=8, n_heads=4, n_kv_heads=2,
                           causal=True, rope=True, activation="identity"),
        RnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                       loss="mcxent")), (2, 5, 8)),
    "residual_block": (lambda: _net(
        ResidualBlock(layers=(
            LayerNorm(n_in=8),
            SelfAttentionLayer(n_in=8, n_out=8, n_heads=2, causal=True,
                               activation="identity"))),
        RnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                       loss="mcxent")), (2, 5, 8)),
}


@pytest.mark.parametrize("name", sorted(GRADCHECK))
def test_gradient_check(name):
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork

    conf, shape = GRADCHECK[name]
    net = MultiLayerNetwork(conf()).init(device="cpu")
    x = _x(20, *shape)
    n_out = net.layers[-1].n_out
    y = np.eye(n_out, dtype=np.float32)[
        np.random.default_rng(21).integers(0, n_out, shape[:-1])]
    before = fa.fwd_counts.plain_calls, fe.counts.plain_calls
    assert check_gradients(net, x, y, epsilon=1e-6, max_rel_error=1e-5,
                           min_abs_error=1e-9)
    # float64 stays on the exact paths
    assert (fa.fwd_counts.plain_calls, fe.counts.plain_calls) == before

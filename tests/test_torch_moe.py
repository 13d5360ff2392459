"""The port's ``MoELayer`` against the JAX package's: the forward on
carried weights in float32 (T = 256 and 2048) and in bfloat16 where the
reference counts positions exactly (at most 256 tokens an expert), the
port's exact int32 positions at 2048 tokens an expert in bfloat16 (where
the reference's bfloat16 count is not), the dispatch and combine
without a ``[T, E, C]`` tensor, three Adam steps of the reference's own
MoE test net, and its JSON and zip.

Tolerances: the layer at ``atol=1e-5`` (float32); bfloat16 within a
tenth of the output scale; the Adam steps at ``rtol=1e-4, atol=1e-5``."""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu_torch.models import serialization
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import MoELayer

ATOL = 1e-5
RTOL_FIT, ATOL_FIT = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _pair(d, E, cf, hidden=32, seed=0):
    kw = dict(n_in=d, n_out=d, num_experts=E, hidden=hidden,
              capacity_factor=cf, name="moe")
    j, t = jl.MoELayer(**kw), MoELayer(**kw)
    p = _np(j.init(jax.random.key(seed)))
    # biases off zero, so the combine's bias path is held too
    rs = np.random.RandomState(seed + 1)
    p["b_up"] = (0.1 * rs.randn(*p["b_up"].shape)).astype(np.float32)
    p["b_down"] = (0.1 * rs.randn(*p["b_down"].shape)).astype(np.float32)
    return j, t, p, {k: torch.tensor(v) for k, v in p.items()}


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("T,E,cf", [(256, 4, 1.25), (2048, 4, 1.25),
                                    (2048, 2, 0.5)])
def test_forward_matches_jax_float32(T, E, cf):
    """Dispatch, expert FFNs, gated combine and residual on carried
    weights; cf 0.5 drops about half the tokens to the residual."""
    j, t, p, pt = _pair(16, E, cf)
    x = _tokens(2, T, 16)
    want = np.asarray(j.apply(p, {}, jnp.asarray(x))[0])
    got = t.apply(pt, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    r = t.route(pt, torch.tensor(x))
    assert r.capacity == max(1, int(cf * T / E))
    if cf < 1:
        assert int((~r.kept).sum()) > T // 4


def test_forward_keeps_leading_axes():
    j, t, p, pt = _pair(8, 3, 1.0)
    x = _tokens(3, 4, 50, 8)
    want = np.asarray(j.apply(p, {}, jnp.asarray(x))[0])
    got = t.apply(pt, torch.tensor(x))
    assert tuple(got.shape) == (4, 50, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_bfloat16_matches_jax_where_its_count_is_exact():
    """bfloat16 with 256 tokens over 2 experts (at most 256 an expert:
    the reference's bfloat16 cumsum is exact there) and a capacity no
    token exceeds.  Rows both route to the same expert agree within a
    tenth of the output scale; rounding may flip a near-tied route."""
    j, t, p, pt = _pair(16, 2, 2.0)
    x = _tokens(4, 256, 16)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want = np.asarray(j.apply(jp, {}, jnp.asarray(x, jnp.bfloat16))[0],
                      np.float32)
    xt = torch.tensor(x).bfloat16()
    ptb = {k: v.bfloat16() for k, v in pt.items()}
    got = t.apply(ptb, xt).float().numpy()
    r = t.route(ptb, xt)
    jexp = np.asarray(jnp.argmax(jax.nn.softmax(
        jnp.asarray(x, jnp.bfloat16) @ jp["W_router"], axis=-1), -1))
    same = r.expert.numpy() == jexp
    assert same.mean() >= 0.95, same.mean()
    scale = np.abs(want).max()
    assert np.abs(got[same] - want[same]).max() <= 0.1 * scale


def test_bfloat16_positions_are_exact_at_2048_an_expert():
    """4096 bfloat16 tokens over 2 experts (about 2048 each; capacity
    2048): each token's position is the exact count of the tokens
    before it that chose its expert (numpy's int64 cumsum of the port's
    own routing), the kept tokens are those below the capacity, and the
    output equals a float64 one-hot dispatch and combine over the same
    routing within bfloat16 rounding.  The reference's bfloat16 count
    cannot do this: its cumsum of 2048 ones has fewer distinct values."""
    _, t, _, pt = _pair(16, 2, 1.0)
    x = torch.tensor(_tokens(5, 4096, 16)).bfloat16()
    ptb = {k: v.bfloat16() for k, v in pt.items()}
    r = t.route(ptb, x)
    assert r.pos.dtype == torch.int32 and r.capacity == 2048
    e = r.expert.numpy()
    onehot = np.eye(2, dtype=np.int64)[e]
    exact = (np.cumsum(onehot, 0) - 1)[np.arange(4096), e]
    np.testing.assert_array_equal(r.pos.numpy(), exact)
    np.testing.assert_array_equal(r.kept.numpy(), exact < 2048)
    assert max(np.bincount(e, minlength=2)) > 2048 - 200
    ref_count = np.asarray(jnp.cumsum(jnp.ones(2048, jnp.bfloat16)))
    assert len(np.unique(ref_count)) < 2048

    # the one-hot form in float64 over the port's routing and weights
    E, C = 2, 2048
    w = {k: v.float().double().numpy() for k, v in ptb.items()}
    tok = x.double().numpy()
    slot = np.zeros((4096, E, C))
    kept = np.nonzero(r.kept.numpy())[0]
    slot[kept, e[kept], exact[kept]] = 1.0
    ein = np.einsum("tec,td->ecd", slot, tok)
    hdn = np.maximum(np.einsum("ecd,edh->ech", ein, w["W_up"])
                     + w["b_up"][:, None], 0.0)
    out = np.einsum("ech,eho->eco", hdn, w["W_down"]) + w["b_down"][:, None]
    want = (np.einsum("tec,eco->to", slot, out)
            * r.gate.double().numpy()[:, None] + tok)
    got = t.apply(ptb, x).double().numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


class _Sizes(TorchDispatchMode):
    """The element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(o):
                self.sizes.append(o.numel())
        return out


def test_no_token_expert_slot_tensor_is_built():
    """The forward and backward at T 2048, E 4 (C 640) make no tensor of
    anything near T·E·C elements: the largest is a tenth of it."""
    _, t, _, pt = _pair(16, 4, 1.25, hidden=64)
    x = torch.tensor(_tokens(6, 2048, 16), requires_grad=True)
    params = {k: v.requires_grad_(True) for k, v in pt.items()}
    with _Sizes() as mode:
        y = t.apply(params, x)
        torch.autograd.grad(y.square().sum(), [x] + list(params.values()))
    tec = 2048 * 4 * t.capacity(2048)
    assert max(mode.sizes) < tec // 10, (max(mode.sizes), tec)


def test_gradients_match_jax():
    j, t, p, pt = _pair(8, 3, 1.0)
    x = _tokens(7, 96, 8)
    g = np.random.RandomState(8).randn(96, 8).astype(np.float32)

    def jloss(pp, xx):
        return jnp.sum(j.apply(pp, {}, xx)[0] * g)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    params = {k: v.requires_grad_(True) for k, v in pt.items()}
    xt = torch.tensor(x, requires_grad=True)
    loss = (t.apply(params, xt) * torch.tensor(g)).sum()
    grads = torch.autograd.grad(loss, [xt] + list(params.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=ATOL)
    for name, gr in zip(params, grads[1:]):
        np.testing.assert_allclose(gr.numpy(), np.asarray(jg[name]),
                                   atol=ATOL, rtol=1e-5)


def _moe_conf(b, layers):
    """The reference's MoE test net (``tests/test_model_parallel.py:112``)."""
    return (b.seed(5).updater("adam", learning_rate=0.02).list()
            .layer(layers.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(layers.MoELayer(n_in=16, n_out=16, num_experts=4,
                                   capacity_factor=2.0))
            .layer(layers.OutputLayer(n_in=16, n_out=4, loss="mcxent",
                                      activation="softmax"))
            .build())


def _moe_pair():
    from deeplearning4j_tpu_torch.nn import layers

    jconf = _moe_conf(JConf.builder(), jl)
    jnet = JNet(jconf).init()
    net = params_from_numpy(MultiLayerConfiguration.from_json(
        jconf.to_json()), _np(jnet.params), device="cpu")
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    assert json.loads(_moe_conf(NeuralNetConfiguration.builder(),
                                layers).to_json()) == \
        json.loads(jconf.to_json())
    return jnet, net


def _data(seed=0, n=64):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]


def test_three_adam_steps_match_jax():
    """Three Adam steps of the reference's MoE net on carried weights
    (its JSON the JAX builder's): losses and parameters agree."""
    jnet, net = _moe_pair()
    for step in range(3):
        x, y = _data(step)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=RTOL_FIT, atol=ATOL_FIT)
    want = _np(jnet.params)
    for name, tree in net.params.items():
        for pname, p in tree.items():
            np.testing.assert_allclose(p.numpy(), want[name][pname],
                                       rtol=RTOL_FIT, atol=ATOL_FIT)


def test_reference_moe_training_case_on_the_port():
    """The reference's ``test_moe_layer_forward_and_training`` on the
    port: 30 Adam steps cut the loss by a fifth; the output rows are
    distributions."""
    _, net = _moe_pair()
    x, y = _data(0)
    s0 = net.score(x, y)
    for _ in range(30):
        net.fit(x, y)
    assert net.score(x, y) < s0 * 0.8
    np.testing.assert_allclose(net.output(x).numpy().sum(-1), 1.0,
                               atol=1e-5)


def test_jax_zip_of_a_moe_net_restores_exactly(tmp_path):
    jnet, _ = _moe_pair()
    x, y = _data(3)
    jnet.fit(x, y)
    path = tmp_path / "moe.zip"
    jnet.save(str(path))
    net = serialization.restore_multi_layer_network(path, device="cpu")
    want = _np(jnet.params)
    for name, tree in net.params.items():
        for pname, p in tree.items():
            np.testing.assert_array_equal(p.numpy(), want[name][pname])
    np.testing.assert_allclose(net.output(x).numpy(), jnet.output(x),
                               rtol=1e-4, atol=ATOL)
    assert {k: tuple(v.shape) for k, v in net.params["layer_1"].items()} \
        == {"W_router": (16, 4), "W_up": (4, 16, 64), "b_up": (4, 64),
            "W_down": (4, 64, 16), "b_down": (4, 16)}

"""The port's slot-mesh constructors against the reference's
(``backend/device.py``): ``default_mesh``'s layout and errors,
``slice_mesh``'s slice-contiguous order, and ``_group_by_slice`` on stub
devices — where a mix of devices with and without ``slice_index``
raises in the port (the reference puts the latter into a slice −1 of
their own without a word; ROADMAP A10)."""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.backend import device as jdev

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.backend import mesh as tmesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator

from tests._torch_parallel_common import data, pair, tvec


class Stub:
    def __init__(self, id, slice_index=None):
        self.id = id
        if slice_index is not None:
            self.slice_index = slice_index


@pytest.mark.parametrize("kw", [dict(data=8), dict(data=2, model=2, seq=2),
                                dict(model=2), dict(seq=4)])
def test_default_mesh_layout_matches_jax(kw):
    j = jdev.default_mesh(devices=jax.devices()[:8], **kw)
    t = tmesh.default_mesh(devices=["cpu"] * 8, **kw)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == dict(j.shape)
    assert t.devices.shape == np.asarray(j.devices).shape


@pytest.mark.parametrize("kw", [dict(model=3), dict(data=3)])
def test_default_mesh_errors_match_jax(kw):
    with pytest.raises(ValueError) as je:
        jdev.default_mesh(devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError) as te:
        tmesh.default_mesh(devices=["cpu"] * 8, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("stubs,n", [
    ([Stub(i) for i in range(8)], 2),
    ([Stub(i, i % 2) for i in range(8)], None),
    ([Stub(i, 1 - i // 4) for i in range(8)], 2),
])
def test_group_by_slice_matches_jax(stubs, n):
    jo, jp = jdev._group_by_slice(stubs, n)
    to, tp = tmesh._group_by_slice(stubs, n)
    assert [d.id for d in to] == [d.id for d in jo] and tp == jp


@pytest.mark.parametrize("stubs,n,match", [
    ([Stub(i) for i in range(8)], 3, "n_slices"),
    ([Stub(i, i % 2) for i in range(8)], 4, "n_slices"),
    ([Stub(i, 0 if i < 5 else 1) for i in range(8)], None, "unequal"),
])
def test_group_by_slice_errors_match_jax(stubs, n, match):
    with pytest.raises(ValueError, match=match):
        jdev._group_by_slice(stubs, n)
    with pytest.raises(ValueError, match=match):
        tmesh._group_by_slice(stubs, n)


def test_a_device_without_slice_index_among_sliced_ones_raises():
    stubs = [Stub(i, i // 4) for i in range(6)] + [Stub(6), Stub(7)]
    with pytest.raises(ValueError, match="slice_index"):
        tmesh._group_by_slice(stubs, None)


def test_slice_mesh_on_slots():
    m = tmesh.slice_mesh(2, model=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2, "seq": 1}
    with pytest.raises(ValueError, match="ICI"):
        tmesh.slice_mesh(8, model=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="n_slices"):
        tmesh.slice_mesh(3, devices=["cpu"] * 8)


def test_dp_training_over_two_virtual_slices_matches_serial():
    x, y = data(64, seed=4)
    _, dist = pair(updater="sgd", lr=0.1)
    _, serial = pair(updater="sgd", lr=0.1)
    tpar.DistributedNetwork(dist, tpar.SyncTrainingMaster(
        mesh=tmesh.slice_mesh(2, devices=["cpu"] * 8))).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    for i in range(0, 64, 16):
        serial.fit(x[i:i + 16], y[i:i + 16])
    np.testing.assert_allclose(tvec(dist), tvec(serial), rtol=2e-5,
                               atol=1e-6)


def test_shardings():
    m = tmesh.default_mesh(devices=["cpu"] * 4)
    assert tuple(tmesh.replicated(m).spec) == ()
    assert tuple(tmesh.data_sharded(m).spec) == ("data",)
    assert tmesh.device_count() == len(tmesh.local_devices()) >= 1

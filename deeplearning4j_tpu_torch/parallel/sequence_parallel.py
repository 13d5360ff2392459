"""Sequence parallelism: ring attention and Ulysses all-to-all — the
port's counterpart of ``deeplearning4j_tpu/parallel/sequence_parallel.py``.

Over a slot mesh the sequence axis is an axis of slots: a shard is
``[S, B, T/S, H, D]``, slot i holding global timesteps ``[i*T/S,
(i+1)*T/S)``.

- ``ring_attention`` folds the S key/value blocks into an online-softmax
  accumulator in float32, rotating K/V (and the padding mask) one slot a
  step with ``backend.mesh.ppermute`` (the reference's ``lax.ppermute``,
  ``:125-133``); every slot folds at once.  Causal, sliding-window and
  GQA (the K/V rotate at ``H_kv`` heads) as the reference.  It is plain
  PyTorch, as the reference's is pure ``lax``: no Pallas kernel to port.
- ``ulysses_attention`` reshards ``[S, B, T/S, H, D]`` to ``[S, B, T,
  H/S, D]`` with ``all_to_all``, runs exact attention per head group
  through the ``"attention"`` helper (the flash kernel on CUDA tensors;
  the slots' head groups go as one batch of ``S*B``), and reshards back.
  GQA (K/V with fewer heads than Q) takes the grouped contraction, as
  the reference bypasses its MHA-only flash helper.
- ``ring_self_attention``: global ``[B, T, H, D]`` in and out.
- ``SequenceParallelTrainingMaster``: batch over ``data``, time over
  ``seq``.  The batch's rows are laid out seq-major, ``[S*B, T/S]``:
  timestep-local layers run on them as they are, and
  ``SelfAttentionLayer(seq_axis=...)`` sees them as ``[S, B, T/S, ...]``
  (``seq_slots``), with RoPE positions offset by the slot's index ×
  T/S.  The loss keeps the reference's convention (``:231-241``):
  per-example sum over time, mean over the batch — the net's data term
  over the ``S*B`` rows times S — with the regulariser counted once (the
  reference scales it to ``reg/ks`` before the sum over ``seq``).  The
  data slots' rows run in the same forward, so the gradient is their
  mean.  One captured step on the card (``common.sgd_step``).
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend.mesh import AXIS_DATA, AXIS_SEQ
from deeplearning4j_tpu_torch.helpers import get_helper
from deeplearning4j_tpu_torch.models import common

_NEG = -1e30


class _Seq(threading.local):
    slots: Dict[str, int] = {}


_seq = _Seq()


@contextlib.contextmanager
def seq_slots(axis: str, size: int):
    """Inside the block, layers with ``seq_axis == axis`` read their
    input's rows as ``size`` sequence slots (``[S*B, T/S, ...]``)."""
    prev = dict(_seq.slots)
    _seq.slots = {**prev, axis: int(size)}
    try:
        yield
    finally:
        _seq.slots = prev


def slots_of(axis: str) -> int:
    """The sequence slots of ``axis`` in force (1 outside a master's
    step: plain attention over the rows)."""
    return _seq.slots.get(axis, 1)


def ring_attention(q, k, v, mask=None, *, axis_name: str = AXIS_SEQ,
                   causal: bool = False, window: Optional[int] = None):
    """Blockwise ring attention over the leading slot dim of ``q``/``k``/
    ``v`` (``[S, B, T_l, H, D]``, ``k``/``v`` at ``H_kv`` heads); ``mask``
    the ``[S, B, T_l]`` key-padding shards.  Returns the ``[S, B, T_l, H,
    D]`` shards of exact attention over the whole sequence."""
    from deeplearning4j_tpu_torch.nn.layers.attention import check_window

    check_window(causal, window)
    S, b, t, h, d = q.shape
    hkv = k.shape[3]
    grouped = hkv != h
    if grouped and h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    groups = h // hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc)
    ar = torch.arange(t, device=q.device)
    idx = torch.arange(S, device=q.device)
    qpos = idx[:, None] * t + ar                          # [S, t]
    o = torch.zeros((S, b, h, t, d), dtype=acc, device=q.device)
    l = torch.zeros((S, b, h, t), dtype=acc, device=q.device)
    m = torch.full((S, b, h, t), _NEG, dtype=acc, device=q.device)
    scale = 1.0 / math.sqrt(d)
    k_cur, v_cur, mask_cur = k, v, mask
    for s in range(S):
        if s:
            # rotate first, then fold: slot j now holds block j - s
            k_cur = mesh_mod.ppermute(k_cur)
            v_cur = mesh_mod.ppermute(v_cur)
            if mask_cur is not None:
                mask_cur = mesh_mod.ppermute(mask_cur)
        src = (idx - s) % S
        kpos = src[:, None] * t + ar                      # [S, t]
        kf = k_cur.to(acc)
        if grouped:
            qg = qf.reshape(S, b, t, hkv, groups, d)
            scores = torch.einsum("sbqhgd,sbkhd->sbhgqk", qg, kf).reshape(
                S, b, h, t, t) * scale
        else:
            scores = torch.einsum("sbqhd,sbkhd->sbhqk", qf, kf) * scale
        valid = None
        if causal:
            valid = qpos[:, :, None] >= kpos[:, None, :]  # [S, tq, tk]
            if window is not None:
                valid = valid & (kpos[:, None, :] > qpos[:, :, None] - window)
            valid = valid[:, None, None]
        if mask_cur is not None:
            mv = mask_cur.bool()[:, :, None, None, :]
            valid = mv if valid is None else valid & mv
        if valid is not None:
            scores = scores.masked_fill(~valid, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        if valid is not None:
            p = p.masked_fill(~valid, 0.0)
        l = l * alpha + p.sum(dim=-1)
        vf = v_cur.to(acc)
        if grouped:
            pv = torch.einsum("sbhgqk,sbkhd->sbhgqd",
                              p.reshape(S, b, hkv, groups, t, t), vf
                              ).reshape(S, b, h, t, d)
        else:
            pv = torch.einsum("sbhqk,sbkhd->sbhqd", p, vf)
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def ulysses_attention(q, k, v, *, axis_name: str = AXIS_SEQ,
                      causal: bool = False, window: Optional[int] = None):
    """DeepSpeed-Ulysses sequence parallelism over the leading slot dim
    (``[S, B, T_l, H, D]``; ``H`` and ``H_kv`` divisible by S)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        check_window, dot_product_attention,
    )

    check_window(causal, window)
    S, b = q.shape[0], q.shape[1]

    def to_heads(x):       # [S, B, T/S, H, D] -> [S, B, T, H/S, D]
        return mesh_mod.all_to_all(x, 3, 2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    t = qh.shape[2]
    flat = [a.reshape((S * b,) + tuple(a.shape[2:])) for a in (qh, kh, vh)]
    helper = get_helper("attention")
    o = None
    if (helper is not None and qh.dtype != torch.float64
            and kh.shape[3] == qh.shape[3]):
        if helper.supports(flat[0]):
            o = helper.attend(*flat, causal=causal, window=window)
        elif flat[0].device.type != "cpu":
            raise TypeError(
                f"ulysses_attention: the flash attention kernels do not "
                f"take {qh.dtype} {tuple(flat[0].shape)} on "
                f"{flat[0].device}")
    if o is None:
        o = dot_product_attention(*flat, causal=causal, window=window)
    o = o.reshape(S, b, t, qh.shape[3], qh.shape[4])
    return mesh_mod.all_to_all(o, 2, 3)


def shard_seq(x: torch.Tensor, s: int) -> torch.Tensor:
    """``[B, T, ...]`` -> the ``[S, B, T/S, ...]`` sequence shards."""
    b, t = x.shape[0], x.shape[1]
    return x.reshape((b, s, t // s) + tuple(x.shape[2:])).transpose(0, 1)


def unshard_seq(x: torch.Tensor) -> torch.Tensor:
    """``[S, B, T/S, ...]`` -> ``[B, T, ...]``."""
    s, b, tl = x.shape[0], x.shape[1], x.shape[2]
    return x.transpose(0, 1).reshape((b, s * tl) + tuple(x.shape[3:]))


def ring_self_attention(q, k, v, mesh=None, *, causal: bool = False,
                        window: Optional[int] = None, impl: str = "ring",
                        seq_axis: str = AXIS_SEQ):
    """Global ``[B, T, H, D]`` in, attention over the mesh's ``seq_axis``
    slots, global ``[B, T, H, D]`` out."""
    mesh = mesh or mesh_mod.default_mesh()
    s = mesh.shape[seq_axis]
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(shard_seq(q, s), shard_seq(k, s), shard_seq(v, s),
             axis_name=seq_axis, causal=causal, window=window)
    return unshard_seq(out)


class SequenceParallelTrainingMaster:
    """Train with the batch over ``data`` and time over ``seq`` (module
    docstring).  Nets: ``MultiLayerNetwork`` stacks of timestep-local
    layers and ``SelfAttentionLayer(seq_axis=...)`` (transformer LMs);
    recurrent layers are not supported, as in the reference."""

    def __init__(self, mesh=None, collect_stats: bool = False):
        self.mesh = mesh or mesh_mod.default_mesh()
        mesh_mod.across_processes("SequenceParallelTrainingMaster",
                                  mesh_mod.A14B, self.mesh)
        self.collect_stats = collect_stats
        self._stats: Dict[str, Any] = {
            "steps": 0, "step_time_ms": collections.deque(maxlen=1024)}

    def _body(self, net, x, y, key, scalars):
        ks = self.mesh.shape[AXIS_SEQ]
        reg_layers = [l for l in net.layers if l.has_params()]

        def loss_of(params, collect=None):
            with seq_slots(AXIS_SEQ, ks):
                full, ns = net._loss_fn(params, x, y, key, None, None,
                                        train=True, collect=collect)
            reg = sum((l.reg_score(params[l.name]) for l in reg_layers),
                      torch.zeros((), device=full.device))
            # data term over S*B rows is sum/(S*B): times S is sum/B
            return (full - reg) * ks + reg, ns

        return common.sgd_step(net, loss_of, scalars)

    def execute_training(self, net, iterator):
        from deeplearning4j_tpu_torch.backend import rng as rng_mod
        from deeplearning4j_tpu_torch.models import capture as cap

        if net.device != self.mesh.device:
            raise ValueError(f"the mesh's slots are on {self.mesh.device}, "
                             f"the net on {net.device}")
        kd = self.mesh.shape[AXIS_DATA]
        ks = self.mesh.shape[AXIS_SEQ]
        common.check_trainable(net)
        for ds in iterator:
            x = ds.features if not isinstance(ds, tuple) else ds[0]
            y = ds.labels if not isinstance(ds, tuple) else ds[1]
            if np.shape(x)[0] % kd or np.shape(x)[1] % ks:
                raise ValueError(
                    f"batch {np.shape(x)[0]} / time {np.shape(x)[1]} must "
                    f"divide mesh (data={kd}, seq={ks})")
            t0 = time.perf_counter()
            # seq-major rows: row s*B + b holds example b's shard s
            xs = _seq_rows(x, ks)
            ys = _seq_rows(y, ks)
            inputs = {"x": xs, "y": ys}
            seed = rng_mod.seed_of(net._keys.next())
            vals = common._step_scalars(net, net.iteration)
            dtype = common._scalar_dtype(net)

            def body(x, y, key, scalars):
                return self._body(net, x, y, key, scalars)

            if cap.captures(net):
                graphs = cap.step_graphs(net)
                inputs = common.tree_map(cap.host_or_device, inputs)
                prog = graphs.program("seq_parallel", body, inputs,
                                      len(vals), dtype,
                                      variant=("seq", kd, ks))
                prog.scalar_names = list(vals)
                graphs.stage(prog, inputs, seed, list(vals.values()))
                loss = graphs.run(prog)
            else:
                dev = net.device
                sc = torch.tensor(list(vals.values()), dtype=dtype,
                                  device=dev)
                loss = body(**common._on(inputs, dev),
                            key=rng_mod.device_key(seed, dev),
                            scalars=dict(zip(vals, sc.unbind(0))))
            net.score_value = loss.clone()
            net.iteration += 1
            if self.collect_stats:
                if loss.is_cuda:
                    torch.cuda.current_stream(loss.device).synchronize()
                self._stats["step_time_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
            self._stats["steps"] += 1
            common.notify_listeners(net, int(np.shape(x)[0]))

    def training_stats(self):
        out = dict(self._stats)
        out["step_time_ms"] = list(out["step_time_ms"])
        return out


def _seq_rows(a, s: int):
    """``[B, T, ...]`` (host or device) -> seq-major rows
    ``[S*B, T/S, ...]``."""
    if torch.is_tensor(a):
        sh = shard_seq(a, s)
        return sh.reshape((-1,) + tuple(sh.shape[2:])).contiguous()
    a = np.asarray(a)
    b, t = a.shape[0], a.shape[1]
    sh = a.reshape((b, s, t // s) + a.shape[2:]).swapaxes(0, 1)
    return np.ascontiguousarray(sh.reshape((s * b, t // s) + a.shape[2:]))

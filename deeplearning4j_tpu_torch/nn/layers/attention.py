"""Multi-head self-attention — counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``.

Ported: ``split_heads``/``merge_heads``, ``rope`` (with [T] or per-row
[B, T] positions), ``dot_product_attention`` (causal, sliding window,
padding mask, GQA contracted on the unexpanded kv heads), the
paged-gather oracle (``gather_pages`` + ``paged_attention``), and
``SelfAttentionLayer`` with ``init``, ``apply`` (train and inference),
the stream caches (``init_cache``, ``cache_overflow``: the linear and the
rolling cache of ``rnn_time_step`` and ``generate``), ``init_paged_cache``
and every branch of ``apply_with_carry``.  ``apply`` asks the helper seam
for flash attention (``helpers/flash_attention.py``), the paged branch
for the fused decode kernel (``helpers/paged_attention.py``).  With
``seq_axis`` set, ``apply`` runs ring attention over the sequence slots
a ``SequenceParallelTrainingMaster`` step puts in force
(``parallel/sequence_parallel.py``), RoPE positions offset by each
slot's index × T/S (reference ``attention.py:480-494``); outside such a
step, or where the axis has one slot, it takes the layer's ordinary
route (RoPE from 0, then the flash helper).  Under the model slots of a
``TensorParallelTrainingMaster`` step, ``Wq``/``Wk``/``Wv`` held
column-parallel give each slot its head group, the slots' groups side by
side on the head axis of one flash call, and ``Wo`` row-parallel is
psum'd (``backend/slots.py``); a kv projection whose blocks end inside a
head (GQA with kv heads that the slots do not divide) is gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.helpers import get_helper
from deeplearning4j_tpu_torch.nn import activations, initializers
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

NEG = -1e30
# a rolling cache's empty slot: far below any reachable qpos - window
KPOS_EMPTY = torch.iinfo(torch.int32).min // 2


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, H*D] -> [B, T, H, D]"""
    b, t, f = x.shape
    return x.reshape(b, t, n_heads, f // n_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B, T, H*D]"""
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def check_window(causal: bool, window: Optional[int]) -> None:
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal=True and window >= 1")


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on [B, T, H, D].  ``positions`` is the
    [T] vector of global positions, or a per-row [B, T] matrix (paged
    decode: every row sits at its own stream position).  An odd tail
    dim passes through unrotated."""
    d = x.shape[-1]
    half = d // 2
    acc = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    # a Python base: no host-to-device copy (and no sync) per call
    freqs = float(theta) ** (-torch.arange(0, half, dtype=acc, device=dev)
                             / max(half, 1))
    ang = positions.to(acc)[..., :, None] * freqs      # [(B,) T, half]
    lead = (None,) if positions.ndim == 1 else (slice(None),)
    idx = lead + (slice(None), None, slice(None))
    cos, sin = torch.cos(ang)[idx], torch.sin(ang)[idx]
    x1 = x[..., :half].to(acc)
    x2 = x[..., half:2 * half].to(acc)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                     x[..., 2 * half:].to(acc)], dim=-1)
    return out.to(x.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          window: Optional[int] = None,
                          mask: Optional[torch.Tensor] = None,
                          q_offset: Union[int, torch.Tensor] = 0,
                          k_offset: Union[int, torch.Tensor] = 0,
                          q_positions: Optional[torch.Tensor] = None,
                          k_positions: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Scaled dot-product attention on [B, T, H, D], softmax in float32
    (float64 for float64 inputs).  GQA (q has G times the kv heads) shares
    each kv head across its G query heads without expanding K/V.  A
    padding ``mask`` [B, Tk] (nonzero = a real key) hides padded keys.

    The causal mask compares global positions: ``q_offset + arange(Tq)``
    against ``k_offset + arange(Tk)``, or the explicit ``q_positions``
    [Tq] / ``k_positions`` [Tk] (a rolling cache stores keys out of
    order).  An offset is an int or a device int tensor; nothing here
    reads it back to the host, so the call can be captured in a CUDA
    graph."""
    check_window(causal, window)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    grouped = hq != hkv
    if grouped:
        qg = q.reshape(b, tq, hkv, hq // hkv, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(acc)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(acc)
    scores = scores / math.sqrt(d)
    if causal:
        qpos = (q_positions if q_positions is not None
                else q_offset + torch.arange(tq, device=q.device))
        kpos = (k_positions if k_positions is not None
                else k_offset + torch.arange(tk, device=q.device))
        cm = qpos[:, None] >= kpos[None, :]
        if window is not None:
            # sliding window: keep kpos in [qpos - window + 1, qpos]
            cm &= kpos[None, :] > qpos[:, None] - window
        scores = scores.masked_fill(~cm, NEG)
    if mask is not None:
        heads = (None,) * (scores.ndim - 3)
        keys = (mask != 0)[(slice(None),) + heads + (None, slice(None))]
        scores = scores.masked_fill(~keys, NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    if grouped:
        o = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
        return o.reshape(b, tq, hq, d)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def gather_pages(pages: torch.Tensor, block: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """One batch's logical KV view from the flattened pool
    [P*page_size, Hkv, D] through ``block`` [B, MAXP]: returns
    [B, MAXP*page_size, Hkv, D], flat index = global stream position."""
    b, maxp = block.shape
    offs = torch.arange(page_size, device=block.device)
    slots = block.to(torch.int64)[:, :, None] * page_size + offs
    return pages[slots.reshape(b, maxp * page_size)]


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``q`` [B, T, H, D] over a gathered paged view
    ``k``/``v`` [B, L, Hkv, D] with per-row query positions [B, T] —
    the oracle the fused kernel is held against."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    kpos = torch.arange(k.shape[1], device=q.device)
    cm = q_positions[:, :, None] >= kpos[None, None, :]     # [B, T, L]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(acc) / math.sqrt(d)
    scores = scores.masked_fill(~cm[:, None, None], NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return o.reshape(b, t, hq, d)


@register_layer
@dataclasses.dataclass(frozen=True)
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over [B, T, F]; params ``Wq/Wk/Wv/Wo``
    ([n_in, n_out] kernels) and ``bq/bk/bv/bo``.  Every field of the
    reference is kept so configs round-trip; ``seq_axis`` names the mesh
    axis whose slots hold the time shards (ring attention)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 4
    causal: bool = False
    activation: str = "identity"
    seq_axis: Optional[str] = None
    flash: bool = True
    max_cache: int = 1024
    rope: bool = False
    rope_theta: float = 10000.0
    n_kv_heads: Optional[int] = None
    window: Optional[int] = None

    _TAKES_MASK = True
    _SLOT_AWARE = True

    @property
    def _kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    def _expand_kv(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, Hkv, D] -> [B, T, H, D]: each kv head shared across its
        query-head group (GQA), for the flash kernels."""
        groups = self.n_heads // self._kv_heads
        return x if groups == 1 else x.repeat_interleave(groups, dim=2)

    def param_shapes(self):
        kv_out = self._kv_heads * (self.n_out // self.n_heads)
        shapes = {}
        for name, (fi, fo) in (("Wq", (self.n_in, self.n_out)),
                               ("Wk", (self.n_in, kv_out)),
                               ("Wv", (self.n_in, kv_out)),
                               ("Wo", (self.n_out, self.n_out))):
            shapes[name] = (fi, fo)
            shapes["b" + name[1].lower()] = (fo,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        if self.n_out % self.n_heads:
            raise ValueError(
                f"n_out={self.n_out} not divisible by n_heads={self.n_heads}")
        if self._kv_heads < 1 or self.n_heads % self._kv_heads:
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be a positive divisor "
                f"of n_heads={self.n_heads}")
        check_window(self.causal, self.window)
        return {name: (initializers.init(self.weight_init, gen, shape, dtype,
                                         device) if name[0] == "W"
                       else torch.zeros(shape, dtype=dtype, device=device))
                for name, shape in self.param_shapes().items()}

    def _qkv(self, params, x):
        hkv = self._kv_heads
        kv_out = hkv * (self.n_out // self.n_heads)
        wk, wv = params["Wk"], params["Wv"]
        if hkv % slots.tp():
            wk = slots.full_leaf(wk, (self.n_in, kv_out))
            wv = slots.full_leaf(wv, (self.n_in, kv_out))
        q = split_heads(slots.linear(x, params["Wq"], self.n_in, self.n_out)
                        + params["bq"], self.n_heads)
        k = split_heads(slots.linear(x, wk, self.n_in, kv_out)
                        + params["bk"], hkv)
        v = split_heads(slots.linear(x, wv, self.n_in, kv_out)
                        + params["bv"], hkv)
        return q, k, v

    def _out(self, params, o):
        y = slots.linear(merge_heads(o), params["Wo"], self.n_out,
                         self.n_out) + params["bo"]
        return activations.get(self.activation)(y)

    def apply(self, params, x, *, train=False, rng=None, mask=None):
        """Routes as the reference (``attention.py:498-510``): with
        ``flash``, no padding mask and a non-float64 type, through the
        ``"attention"`` helper on GQA-expanded heads; otherwise
        ``dot_product_attention``.  With the helpers on, a CUDA tensor on
        that route that the kernels do not take raises instead (float64
        on the card runs under ``helpers.helpers_disabled()``)."""
        x = self.maybe_dropout(x, train=train, rng=rng)
        q, k, v = self._qkv(params, x)
        if self.seq_axis is not None and self._seq_slots() > 1:
            return self._out(params, self._ring(q, k, v, mask))
        if self.rope:
            positions = torch.arange(q.shape[1], device=q.device)
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions, self.rope_theta)
        o = None
        helper = get_helper("attention") if self.flash and mask is None \
            else None
        if helper is not None:
            if helper.supports(q):
                o = helper.attend(q, self._expand_kv(k), self._expand_kv(v),
                                  causal=self.causal, window=self.window)
            elif q.device.type != "cpu":
                raise TypeError(
                    f"SelfAttentionLayer: the flash attention kernels do "
                    f"not take {q.dtype} {tuple(q.shape)} on {q.device}; use "
                    "helpers.helpers_disabled() for the built-in path")
        if o is None:
            # grouped contraction: no KV expansion materialized
            o = dot_product_attention(q, k, v, causal=self.causal,
                                      window=self.window, mask=mask)
        return self._out(params, o)

    def _seq_slots(self) -> int:
        from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp

        return sp.slots_of(self.seq_axis)

    def _ring(self, q, k, v, mask):
        """Ring attention over the sequence slots in force: the rows are
        ``[S*B, T/S]`` seq-major (``sequence_parallel.seq_slots``)."""
        from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp

        s = self._seq_slots()
        rows, tl = q.shape[0], q.shape[1]
        b = rows // s
        if self.rope:
            # slot i holds global timesteps [i*T/S, (i+1)*T/S)
            pos = (torch.arange(s, device=q.device)[:, None] * tl
                   + torch.arange(tl, device=q.device))
            pos = pos.repeat_interleave(b, dim=0)          # [S*B, T/S]
            q = rope(q, pos, self.rope_theta)
            k = rope(k, pos, self.rope_theta)

        def slots(a):
            return a.reshape((s, b) + tuple(a.shape[1:]))

        o = sp.ring_attention(slots(q), slots(k), slots(v),
                              None if mask is None else slots(mask),
                              axis_name=self.seq_axis, causal=self.causal,
                              window=self.window)
        return o.reshape(q.shape)

    def init_cache(self, batch: int, dtype=torch.float32, device=None):
        """KV cache for streaming inference (``rnn_time_step``,
        ``generate``).  Linear mode (no ``window``): ``max_cache`` slots,
        ``pos`` (a device int32 scalar) counts the filled timesteps, and
        overflow is a hard error checked on the host
        (``cache_overflow``).  Rolling mode (``window`` set): ``window``
        slots written modulo the window, each slot's global position in
        ``kpos``: unbounded decode in O(window) memory.  GQA caches hold
        the unexpanded kv heads."""
        length = self.window if self.window is not None else self.max_cache
        shape = (batch, length, self._kv_heads, self.n_out // self.n_heads)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device),
                 "pos": torch.zeros((), dtype=torch.int32, device=device)}
        if self.window is not None:
            cache["kpos"] = torch.full((length,), KPOS_EMPTY,
                                       dtype=torch.int32, device=device)
        return cache

    @staticmethod
    def cache_overflow(carry, t_new: int, pos: Optional[int] = None) -> bool:
        """Would appending ``t_new`` steps pass the end of a linear cache?
        Checked on the host before the call: the in-place write would
        fault (the reference's ``dynamic_update_slice`` would clamp).
        Rolling caches never overflow.  ``pos`` is the facade's host-side
        stream position; without it the device scalar is read (a sync)."""
        if "kpos" in carry:
            return False
        if pos is None:
            pos = int(carry["pos"])
        return pos + t_new > carry["k"].shape[1]

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.float32, device=None):
        """K/V pools [num_pages, page_size, Hkv, D] for paged streaming
        inference; requests address their pages through the int32
        block table the engine attaches per call."""
        if self.window is not None:
            raise ValueError(
                "paged KV caching does not support sliding-window "
                f"attention (window={self.window})")
        if not self.causal or self.seq_axis is not None:
            raise ValueError(
                "paged KV caching requires causal=True attention without "
                f"seq_axis (got causal={self.causal}, "
                f"seq_axis={self.seq_axis})")
        shape = (num_pages, page_size, self._kv_heads,
                 self.n_out // self.n_heads)
        return {"pk": torch.zeros(shape, dtype=dtype, device=device),
                "pv": torch.zeros(shape, dtype=dtype, device=device)}

    def _apply_paged(self, params, q, k, v, carry):
        """Write this chunk's K/V into the pool at the rows' global
        positions through the block table, then attend causally by
        per-row position.  Write-before-attend makes the chunk's own
        keys visible to its later queries."""
        block, pos = carry["block"], carry["pos"]      # [B, MAXP], [B] int32
        ps = carry["pk"].shape[1]
        t_new = q.shape[1]
        new_pos = pos[:, None] + torch.arange(t_new, dtype=pos.dtype,
                                              device=pos.device)
        if self.rope:
            q = rope(q, new_pos, self.rope_theta)
            k = rope(k, new_pos, self.rope_theta)
        # padding past the block table clamps to its last entry, as
        # XLA's gather does in the reference
        pidx = (new_pos // ps).clamp(max=block.shape[1] - 1).to(torch.int64)
        page = torch.gather(block, 1, pidx).to(torch.int64)
        flat = (page * ps + (new_pos % ps)).reshape(-1)
        hkv, dh = k.shape[2], k.shape[3]
        pkf = carry["pk"].view(-1, hkv, dh)
        pvf = carry["pv"].view(-1, hkv, dh)
        # in place: the engine owns the pools and hands the same tensors
        # back every call (the reference donates them to XLA instead)
        pkf[flat] = k.reshape(-1, hkv, dh).to(pkf.dtype)
        pvf[flat] = v.reshape(-1, hkv, dh).to(pvf.dtype)
        helper = get_helper("paged_attention")
        if helper is not None and helper.supports(q, ps):
            o = helper.attend(q, pkf, pvf, block, new_pos, page_size=ps)
        else:
            # the gather+softmax oracle
            gk = gather_pages(pkf, block, ps).to(q.dtype)
            gv = gather_pages(pvf, block, ps).to(q.dtype)
            o = paged_attention(q, gk, gv, new_pos)
        new_carry = {"pk": carry["pk"], "pv": carry["pv"], "block": block,
                     "pos": pos + t_new}
        return self._out(params, o), new_carry

    def _apply_stream(self, params, q, k, v, carry):
        """The linear and rolling stream caches (``init_cache``).  Keys are
        stored after RoPE, at their global positions.  The cache tensors
        are updated in place and handed back in the same dict (the
        reference returns new arrays), so a captured CUDA graph sees them
        at fixed addresses; ``pos`` advances in place too."""
        pos = carry["pos"]
        t_new = q.shape[1]
        new_pos = pos + torch.arange(t_new, dtype=pos.dtype,
                                     device=pos.device)
        if self.rope:
            q = rope(q, new_pos, self.rope_theta)
            k = rope(k, new_pos, self.rope_theta)
        kc, vc = carry["k"], carry["v"]
        if "kpos" in carry:
            # rolling: attend over [old ring || this chunk] first (writing
            # first would clobber keys still in band for the chunk's
            # earlier rows), then write the chunk's last min(t_new, window)
            # positions modulo the window
            ring = kc.shape[1]
            o = dot_product_attention(
                q, torch.cat([kc.to(q.dtype), k.to(q.dtype)], dim=1),
                torch.cat([vc.to(q.dtype), v.to(q.dtype)], dim=1),
                causal=True, window=self.window, q_positions=new_pos,
                k_positions=torch.cat([carry["kpos"], new_pos]))
            if t_new > ring:
                k, v, new_pos = k[:, -ring:], v[:, -ring:], new_pos[-ring:]
            slots = (new_pos % ring).to(torch.int64)
            kc.index_copy_(1, slots, k.to(kc.dtype))
            vc.index_copy_(1, slots, v.to(vc.dtype))
            carry["kpos"].index_copy_(0, slots, new_pos)
        else:
            # linear: write at pos + arange(t_new), then attend by global
            # position (which also hides the unfilled tail); overflow was
            # refused on the host (cache_overflow)
            slots = new_pos.to(torch.int64)
            kc.index_copy_(1, slots, k.to(kc.dtype))
            vc.index_copy_(1, slots, v.to(vc.dtype))
            o = dot_product_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                      causal=True, window=self.window,
                                      q_offset=pos)
        pos.add_(t_new)
        return self._out(params, o), carry

    def apply_with_carry(self, params, x, carry, *, train=False, rng=None,
                         mask=None):
        """carry=None -> ``apply``.  With a paged carry (``"pk"`` in it):
        append this call's K/V to the pool and attend the new queries
        over everything the rows have written.  With a stream cache
        (``init_cache``): append to the linear or rolling cache, in
        place, and attend over the cached prefix."""
        if carry is None:
            return self.apply(params, x, train=train, rng=rng,
                              mask=mask), None
        if not self.causal or self.seq_axis is not None or mask is not None:
            raise ValueError(
                "KV-cache streaming requires causal=True attention without "
                "seq_axis or padding masks; got "
                f"causal={self.causal}, seq_axis={self.seq_axis}, "
                f"mask={'set' if mask is not None else None}")
        x = self.maybe_dropout(x, train=train, rng=rng)
        q, k, v = self._qkv(params, x)
        if "pk" in carry:
            return self._apply_paged(params, q, k, v, carry)
        return self._apply_stream(params, q, k, v, carry)

"""Batched embedding updates — counterpart of
``deeplearning4j_tpu/nlp/learning.py``: skip-gram and CBOW under
negative sampling and hierarchical softmax, and the GloVe AdaGrad step.

Reference semantics: ``SkipGram.java:124-194`` (input vector = the syn0
row of the context word, output rows those of the center word's Huffman
path or samples; g = (label − σ)·lr) and ``CBOW.java`` (input = the mean
of the context rows).  As in the reference package, a whole batch of
pairs is one device program: gathers, the logits as batched products,
the sigmoid gradients, and ``index_add_`` into the matrices.

Each step is a plain function on tensors.  It reads every gathered row
before it writes any (so both the scale and the update see the pre-step
matrices), updates its matrices in place and returns the loss as a
device scalar.  A row hit several times in a batch receives the mean of
its pair updates (``_row_mean_scale``).  No index may reach a matrix's
row count: a CUDA gather past the end kills the context, where JAX
clamps; the CBOW contexts are clamped to row 0 and masked, as are the
Huffman paths' padded points.

``StepPrograms`` runs a fit's steps: on the card each padded batch shape
is one captured CUDA graph (``models/capture.py``'s ``StepGraphs`` on a
holder of the fit's tensors, its index buffers staged from the pinned
ring), as the reference jits one program a shape; on the CPU the same
bodies run eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import rng
from deeplearning4j_tpu_torch.models import capture, common


def _log_sigmoid(x):
    return -torch.logaddexp(torch.zeros_like(x), -x)


def _row_mean_scale(num_rows, idx, m, dtype):
    """1/multiplicity per occurrence, so that colliding rows receive the
    MEAN of their pair updates instead of the sum (the reference's
    stable, deterministic analogue of Hogwild's interleaving)."""
    counts = torch.zeros((num_rows,), dtype=dtype, device=idx.device)
    counts.index_add_(0, idx, m.to(dtype))
    return 1.0 / torch.clamp(counts[idx], min=1.0)


def _pair_loss(m, labels, logits):
    return -(m * (labels * _log_sigmoid(logits)
                  + (1 - labels) * _log_sigmoid(-logits))).sum()


def _ns_outputs(targets, negs, dtype):
    """The output rows (the positive word, then the negatives) and their
    labels."""
    B, K = negs.shape
    out_idx = torch.cat([targets[:, None], negs.to(targets.dtype)], 1)
    labels = torch.cat([torch.ones((B, 1), dtype=dtype, device=negs.device),
                        torch.zeros((B, K), dtype=dtype, device=negs.device)],
                       1)
    return out_idx, labels


def _context_mean(syn0, contexts, ctx_mask):
    """CBOW's input: the mean of the (clamped, masked) context rows."""
    safe_ctx = torch.clamp(contexts, min=0)
    cvecs = syn0[safe_ctx] * ctx_mask[..., None]                     # [B,C,D]
    counts = torch.clamp(ctx_mask.sum(-1, keepdim=True), min=1.0)    # [B,1]
    return safe_ctx, cvecs.sum(1) / counts, counts


# ---------------------------------------------------------------------------
# negative-sampling steps
# ---------------------------------------------------------------------------

def sg_ns_step(syn0, syn1neg, inputs, targets, negs, mask, lr, *,
               update_out: bool = True):
    """One skip-gram negative-sampling batch.

    inputs  [B]    — syn0 rows to train (context words; DBOW: doc labels)
    targets [B]    — positive output words (window centers)
    negs    [B,K]  — sampled negative words
    mask    [B]    — 1.0 for real pairs, 0.0 padding
    ``update_out=False`` leaves ``syn1neg`` as it is (inference against
    frozen output weights).
    """
    D = syn0.shape[1]
    out_idx, labels = _ns_outputs(targets, negs, syn0.dtype)
    h = syn0[inputs]                                                 # [B,D]
    w = syn1neg[out_idx]                                             # [B,1+K,D]
    logits = torch.einsum("bd,bkd->bk", h, w)
    g = (labels - torch.sigmoid(logits)) * lr * mask[:, None]        # [B,1+K]
    dh = torch.einsum("bk,bkd->bd", g, w)                            # [B,D]
    in_scale = _row_mean_scale(syn0.shape[0], inputs, mask, syn0.dtype)
    if update_out:
        dw = g[..., None] * h[:, None, :]                            # [B,1+K,D]
        flat_out = out_idx.reshape(-1)
        out_mask = mask[:, None].expand(out_idx.shape).reshape(-1)
        out_scale = _row_mean_scale(syn1neg.shape[0], flat_out, out_mask,
                                    syn0.dtype)
    syn0.index_add_(0, inputs, dh * in_scale[:, None])
    if update_out:
        syn1neg.index_add_(0, flat_out, dw.reshape(-1, D) * out_scale[:, None])
    return _pair_loss(mask[:, None], labels, logits)


def sg_hs_step(syn0, syn1, inputs, points, codes, code_mask, mask, lr, *,
               update_out: bool = True):
    """One skip-gram hierarchical-softmax batch.

    points    [B,L] — inner-node rows (of the center word's Huffman path)
    codes     [B,L] — bit labels along the path (0/1)
    code_mask [B,L] — 1.0 within path length
    """
    D = syn0.shape[1]
    h = syn0[inputs]                                                 # [B,D]
    w = syn1[points]                                                 # [B,L,D]
    logits = torch.einsum("bd,bld->bl", h, w)
    labels = 1.0 - codes                                             # word2vec convention
    m = code_mask * mask[:, None]
    g = (labels - torch.sigmoid(logits)) * lr * m                    # [B,L]
    dh = torch.einsum("bl,bld->bd", g, w)
    in_scale = _row_mean_scale(syn0.shape[0], inputs, mask, syn0.dtype)
    if update_out:
        dw = g[..., None] * h[:, None, :]
        flat_pts = points.reshape(-1)
        pt_scale = _row_mean_scale(syn1.shape[0], flat_pts, m.reshape(-1),
                                   syn0.dtype)
    syn0.index_add_(0, inputs, dh * in_scale[:, None])
    if update_out:
        syn1.index_add_(0, flat_pts, dw.reshape(-1, D) * pt_scale[:, None])
    return _pair_loss(m, labels, logits)


# ---------------------------------------------------------------------------
# CBOW steps (also Paragraph-Vectors DM when the label row is appended to
# the context group)
# ---------------------------------------------------------------------------

def cbow_ns_step(syn0, syn1neg, contexts, ctx_mask, targets, negs, mask, lr):
    """One CBOW negative-sampling batch.

    contexts [B,C] — context-word rows (−1-padded → masked by ctx_mask)
    ctx_mask [B,C] — 1.0 for real context members
    targets  [B]   — center words to predict
    """
    D = syn0.shape[1]
    safe_ctx, h, counts = _context_mean(syn0, contexts, ctx_mask)
    out_idx, labels = _ns_outputs(targets, negs, syn0.dtype)
    w = syn1neg[out_idx]
    logits = torch.einsum("bd,bkd->bk", h, w)
    g = (labels - torch.sigmoid(logits)) * lr * mask[:, None]
    dh = torch.einsum("bk,bkd->bd", g, w) / counts                   # split over members
    dw = g[..., None] * h[:, None, :]
    dctx = dh[:, None, :] * ctx_mask[..., None]                      # [B,C,D]
    flat_ctx = safe_ctx.reshape(-1)
    ctx_occ = (ctx_mask * mask[:, None]).reshape(-1)
    ctx_scale = _row_mean_scale(syn0.shape[0], flat_ctx, ctx_occ, syn0.dtype)
    flat_out = out_idx.reshape(-1)
    out_mask = mask[:, None].expand(out_idx.shape).reshape(-1)
    out_scale = _row_mean_scale(syn1neg.shape[0], flat_out, out_mask,
                                syn0.dtype)
    syn0.index_add_(0, flat_ctx, dctx.reshape(-1, D) * ctx_scale[:, None])
    syn1neg.index_add_(0, flat_out, dw.reshape(-1, D) * out_scale[:, None])
    return _pair_loss(mask[:, None], labels, logits)


def cbow_hs_step(syn0, syn1, contexts, ctx_mask, points, codes, code_mask,
                 mask, lr):
    """One CBOW hierarchical-softmax batch."""
    D = syn0.shape[1]
    safe_ctx, h, counts = _context_mean(syn0, contexts, ctx_mask)
    w = syn1[points]
    logits = torch.einsum("bd,bld->bl", h, w)
    labels = 1.0 - codes
    m = code_mask * mask[:, None]
    g = (labels - torch.sigmoid(logits)) * lr * m
    dh = torch.einsum("bl,bld->bd", g, w) / counts
    dw = g[..., None] * h[:, None, :]
    dctx = dh[:, None, :] * ctx_mask[..., None]
    flat_ctx = safe_ctx.reshape(-1)
    ctx_occ = (ctx_mask * mask[:, None]).reshape(-1)
    ctx_scale = _row_mean_scale(syn0.shape[0], flat_ctx, ctx_occ, syn0.dtype)
    flat_pts = points.reshape(-1)
    pt_scale = _row_mean_scale(syn1.shape[0], flat_pts, m.reshape(-1),
                               syn0.dtype)
    syn0.index_add_(0, flat_ctx, dctx.reshape(-1, D) * ctx_scale[:, None])
    syn1.index_add_(0, flat_pts, dw.reshape(-1, D) * pt_scale[:, None])
    return _pair_loss(m, labels, logits)


# ---------------------------------------------------------------------------
# GloVe step (weighted least squares + AdaGrad)
# ---------------------------------------------------------------------------

def glove_step(w, wc, b, bc, hw, hwc, hb, hbc, rows, cols, xij, mask, lr,
               x_max, alpha):
    """One GloVe batch: minimise f(X)(wᵢ·w̃ⱼ + bᵢ + b̃ⱼ − log Xᵢⱼ)² with
    per-coordinate AdaGrad (≙ ``learning/impl/elements/GloVe.java``,
    re-batched).  w/wc [V,D] main/context embeddings, b/bc [V] biases,
    h* the AdaGrad squared-gradient accumulators.

    As the reference, each accumulator first adds every occurrence's
    squared gradient and only then gathers its rows, so a duplicated row
    sees the batch's whole sum."""
    wi = w[rows]
    wj = wc[cols]
    diff = (torch.einsum("bd,bd->b", wi, wj) + b[rows] + bc[cols]
            - torch.log(torch.clamp(xij, min=1e-12)))
    f = torch.clamp((xij / x_max) ** alpha, max=1.0) * mask
    g = f * diff                                                     # [B]
    gw = g[:, None] * wj
    gwc = g[:, None] * wi
    eps = 1e-8

    def ada(hist, idx, grad):
        hist.index_add_(0, idx, grad * grad)
        return lr / torch.sqrt(hist[idx] + eps) * grad

    step_w = ada(hw, rows, gw)
    step_wc = ada(hwc, cols, gwc)
    step_b = ada(hb, rows, g)
    step_bc = ada(hbc, cols, g)
    w.index_add_(0, rows, -step_w)
    wc.index_add_(0, cols, -step_wc)
    b.index_add_(0, rows, -step_b)
    bc.index_add_(0, cols, -step_bc)
    return 0.5 * (f * diff * diff).sum()


# ---------------------------------------------------------------------------
# the captured steps
# ---------------------------------------------------------------------------

class StepPrograms:
    """A fit's device tensors and its step programs.  ``state`` names
    every tensor the steps read or write in place (the matrices, the
    Huffman tables, the loss accumulator): a program captured against
    them is captured again if one is replaced.

    ``call(kind, body, inputs, seed, scalars)`` runs
    ``body(**inputs, key=, scalars=)``: on the card through the holder's
    ``StepGraphs`` (the first call of a kind and input signature runs
    eagerly on the side stream and is captured; later calls replay, the
    inputs staged from pinned buffers and the key and scalars rewritten
    on the device); elsewhere, or with ``capture=False`` (a model's
    internal ``_capture = False``: the comparison runs), eagerly, the key
    a device key of ``seed``.  Returns the body's output (on a replay,
    the graph's static output, which the next replay rewrites)."""

    def __init__(self, device: torch.device,
                 state: Dict[str, torch.Tensor], capture: bool = True):
        self.device = device
        self.params = state
        self.updater_state: dict = {}
        self.net_state: dict = {}
        self.conf = None
        self._graph_cache: dict = {}
        self._capture = capture

    def counts(self) -> Dict[str, int]:
        """Captures and replays so far."""
        g = getattr(self, "_step_graphs", None)
        return {"captures": g.captures if g else 0,
                "replays": g.replays if g else 0}

    def call(self, kind: str, body: Callable, inputs: Dict[str, np.ndarray],
             seed: Optional[int] = None,
             scalars: Sequence = ()):
        names = [n for n, _ in scalars]
        vals = [float(v) for _, v in scalars]
        if capture.captures(self):
            graphs = capture.step_graphs(self)
            inputs = common.tree_map(capture.host_or_device, inputs)
            prog = graphs.program(kind, body, inputs, len(vals))
            prog.scalar_names = names
            graphs.stage(prog, inputs, 0 if seed is None else seed, vals)
            return graphs.run(prog)
        dev = self.device
        sc = torch.tensor(vals, dtype=torch.float32, device=dev)
        return body(**{k: torch.as_tensor(np.ascontiguousarray(v),
                                          device=dev)
                       for k, v in inputs.items()},
                    key=rng.device_key(0 if seed is None else seed, dev),
                    scalars=dict(zip(names, sc.unbind(0))))

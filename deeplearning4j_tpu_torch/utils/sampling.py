"""Per-row sampling for a mixed decode batch — counterpart of
``sample_tokens``/``_filter_logits`` in ``deeplearning4j_tpu/utils/sampling.py``.

Greedy rows (temperature <= 0) take the argmax, exactly as the
reference.  A sampled row draws from a CPU ``torch.Generator`` seeded by
(request seed, token index) alone, so a request's stream never depends
on its slot or on who shares the batch.  The reference's
``fold_in``/threefry draws cannot be reproduced in torch, so seeded
streams match the port's own, not the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e30
_SEED_MASK = 2 ** 63 - 1


def _filter_logits(logits: torch.Tensor, top_k=None,
                   top_p=None) -> torch.Tensor:
    """Per-row top-k / nucleus filtering: everything outside the kept set
    drops to -1e30.  ``top_k`` [B] int (< 1 disables that row),
    ``top_p`` [B] float (>= 1 keeps everything)."""
    neg = torch.tensor(NEG, dtype=logits.dtype, device=logits.device)
    v = logits.shape[-1]
    if top_k is not None:
        karr = top_k.to(torch.int64)
        k = torch.where(karr >= 1, karr.clamp(max=v), torch.full_like(karr, v))
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        kth = torch.gather(sorted_desc, -1, (k - 1)[..., None])
        logits = torch.where(logits >= kth, logits, neg)
    if top_p is not None:
        p = top_p.to(logits.dtype).clamp(torch.finfo(logits.dtype).tiny,
                                         1.0)[..., None]
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (always
        # keep the argmax); threshold = the smallest kept logit
        keep_sorted = cum - probs < p
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits, neg)
    return logits


def base_key(seed: int) -> np.ndarray:
    """A request's [2] uint32 key (the scheduler's per-slot key row): the
    seed's low and high 32 bits."""
    seed = int(seed) & (2 ** 64 - 1)
    return np.asarray([seed & 0xFFFFFFFF, seed >> 32], np.uint32)


def _draw_seed(key: np.ndarray, token_idx: int) -> int:
    """Generator seed for one draw: a mix of the request seed and the
    index of the token being drawn (splitmix64 constants)."""
    seed = int(key[0]) | (int(key[1]) << 32)
    z = (seed * 0x9E3779B97F4A7C15 + (int(token_idx) + 1)
         * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z ^= z >> 31
    return z & _SEED_MASK


def sample_tokens(logits: torch.Tensor, keys, token_idx, temperature,
                  top_k, top_p) -> torch.Tensor:
    """``logits`` [B, V] on the device; the per-row policy arrays are the
    scheduler's host arrays: ``keys`` [B, 2] uint32, ``token_idx`` [B],
    ``temperature`` [B] (<= 0 -> greedy), ``top_k`` [B] (< 1 disables),
    ``top_p`` [B] (>= 1 disables).  Returns [B] int64 token ids on the
    logits' device.  Sampled rows use the Gumbel-max draw over the
    filtered logits."""
    out = torch.argmax(logits, dim=-1)
    temperature = np.asarray(temperature, np.float32)
    rows = np.flatnonzero(temperature > 0)
    if rows.size == 0:
        return out
    dev = logits.device
    sel = torch.as_tensor(rows, device=dev)
    temp = torch.as_tensor(temperature[rows], device=dev)
    filtered = _filter_logits(
        logits[sel] / temp[:, None].to(logits.dtype),
        torch.as_tensor(np.asarray(top_k)[rows], device=dev),
        torch.as_tensor(np.asarray(top_p, np.float32)[rows], device=dev))
    v = logits.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    noise = torch.stack([
        -torch.log(-torch.log(torch.rand(
            v, generator=torch.Generator().manual_seed(
                _draw_seed(keys[r], token_idx[r]))).clamp_min(tiny)))
        for r in rows])
    out[sel] = torch.argmax(filtered + noise.to(dev, logits.dtype), dim=-1)
    return out

"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU: every test skips without one.  The file imports no
JAX, so it runs on a machine that has none; run it there without the
session conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 to 1e-4 absolute; bfloat16 to 2e-2 absolute, the
plain version fed the same bfloat16 tensors (it accumulates in float32
like the kernel; the two round at different places)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.helpers import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _case(seed, b, t, hq, hkv, d, *, ps=16, maxp=32, pages=513,
          dtype=torch.bfloat16, device="cuda"):
    """Engine-shaped inputs: page 0 is the trash page; row 0 is an idle
    slot (all-trash block row, positions from 0); the other rows end at
    random positions in partly filled pages."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    pk = torch.randn(pages * ps, hkv, d, generator=g)
    pv = torch.randn(pages * ps, hkv, d, generator=g)
    q = torch.randn(b, t, hq, d, generator=g)
    block = rng.integers(1, pages, size=(b, maxp)).astype(np.int32)
    last = rng.integers(t - 1, maxp * ps, size=(b,))
    last[0] = t - 1
    block[0] = 0
    for i in range(b):
        block[i, int(last[i]) // ps + 1:] = 0
    qpos = ((last - (t - 1))[:, None] + np.arange(t)).astype(np.int32)
    dev = torch.device(device)
    return ([x.to(dev, dtype) for x in (q, pk, pv)]
            + [torch.from_numpy(block).to(dev), torch.from_numpy(qpos).to(dev)])


CASES = {
    "decode": (16, 1, 8, 8, 128),
    "prefill": (1, 16, 8, 8, 128),
    "gqa": (16, 1, 8, 2, 128),
    "gqa_chunk": (3, 5, 8, 2, 64),
    "d32": (4, 2, 4, 4, 32),
    "d256": (2, 3, 4, 2, 256),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(name, dtype, cuda):
    args = _case(7, *CASES[name], dtype=dtype)
    before = pa.counts.launches
    out = pa.paged_decode_attention(*args, page_size=16)
    assert pa.counts.launches == before + 1
    ref = pa.paged_attention_plain(*args, 16)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == args[0].shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, pk, pv, block, qpos = _case(1, 2, 1, 4, 4, 128)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.half(), pk.half(), pv.half(), block,
                                  qpos, page_size=16)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, pk, pv, block.long(), qpos,
                                  page_size=16)
    q, pk, pv, block, qpos = _case(1, 2, 3, 4, 4, 128)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), pk, pv, block, qpos,
                                  page_size=16)
    q, pk, pv, block, qpos = _case(1, 2, 1, 4, 4, 12)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q, pk, pv, block, qpos, page_size=16)


def test_engine_goes_through_the_kernel(cuda):
    """A small bfloat16 model served on the card launches the kernel once
    per attention layer per call and never runs the plain version."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm

    net = transformer_char_lm(vocab_size=29, d_model=64, n_heads=4,
                              layers=2, compute_dtype="bfloat16")
    pa.counts.reset()
    eng = GenerationEngine(net, slots=4, page_size=16, max_context=64,
                           prefill_buckets=(16,)).start()
    try:
        outs = [h.result(timeout=60) for h in
                [eng.submit([1 + i, 2, 3], 12) for i in range(6)]]
    finally:
        eng.stop()
    assert all(len(o) == 12 for o in outs)
    calls = eng.programs.prefill_calls + eng.programs.decode_calls
    assert pa.counts.launches == 2 * calls and pa.counts.plain_calls == 0

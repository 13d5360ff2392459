"""How fast two gloo processes on one host all-gather a large payload, by
the number of process groups the payload is split over, as
``backend.mesh.process_all_gather`` splits it (``GLOO_STREAMS``):

    python3 scripts/torch_gloo_streams.py [--device cuda|cpu]
                                          [--gib 1.0] [--calls 3]

Each process holds ``--gib`` GiB of float32 and gathers the other's.
For 1, 2 and 4 groups it prints every call's seconds (the slower rank's)
and the rate a rank sends: the first call of a size apart from the
next.  On ``cuda`` (both processes on ``cuda:0``) gloo copies the card's
tensors through pinned host buffers of its own, which the host
allocator keeps for the next call of the same size (so each process
holds about three times the payload's host memory a group count, and
the default size stays at 1 GiB); the ``staged`` rows copy them
through pinned host buffers made before the clock starts instead, which
tells the first call's extra cost (gloo's own pinned buffers) from the
wire's.  The card's name and power limit come first; ``--device cpu``
needs no card.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import socket
import subprocess
import sys
import time


def _child(rank, port, q, n, device, calls):
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    groups = [dist.new_group([0, 1], backend="gloo") for _ in range(4)]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def gather(src, out, k):
        gs = groups[:k] if k > 1 else [None]
        works = [dist.all_gather(list(o.unbind(0)), c, group=g,
                                 async_op=True)
                 for c, o, g in zip(src.chunk(len(gs)),
                                    out.chunk(len(gs), dim=1), gs)]
        for w in works:
            w.wait()

    x = torch.ones(n, device=device)
    rows = []
    for k in (1, 2, 4):
        out = torch.empty((2, n), device=device)
        for i in range(calls):
            sync()
            t = time.perf_counter()
            gather(x, out, k)
            sync()
            rows.append((f"{device} {k} group(s) call {i}",
                         time.perf_counter() - t))
        del out
    if device == "cuda":
        pin_in = torch.empty(n, pin_memory=True)
        pin_out = torch.empty((2, n), pin_memory=True)
        back = torch.empty((2, n), device="cuda")
        for k in (1, 4):
            for i in range(calls):
                sync()
                t = time.perf_counter()
                pin_in.copy_(x)
                gather(pin_in, pin_out, k)
                back.copy_(pin_out)
                sync()
                rows.append((f"staged {k} group(s) call {i}",
                             time.perf_counter() - t))
    q.put((rank, rows))
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device available", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    n = int(args.gib * 2 ** 30) // 4
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, port, q, n, args.device,
                                              args.calls))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=1800) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    for (name, a), (_, b) in zip(got[0], got[1]):
        t = max(a, b)
        print(f"{name}: {t:.3f} s, {n * 4 / t / 1e9:.2f} GB/s sent a rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())

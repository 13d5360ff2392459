"""Whether ``torch.profiler`` keeps every kernel of a replayed CUDA graph
near the edges of its window, on one CUDA card:

    python3 scripts/torch_profiler_window_probe.py [--minutes 3]
                                                  [--calls 8]

A graph of 16 small in-place kernels is replayed ``--calls`` times in
each profiled window, the windows spread over ``--minutes`` of the
process's life, and they alternate between two forms:

- ``bare``: the profiler opened, one short kernel waited for, the
  replays, a synchronize, the profiler closed (``chip_smoke.py``'s
  windows before they took margins);
- ``padded``: the same with ``chip_smoke.traced``'s host margins after
  that first kernel and after the synchronize.

For each form it prints the windows that lost kernel records and how
many they lost, and the edge gaps as the profiler reports them: the
first graph kernel's start less the trace's start, and the host clock
just after the synchronize less the last graph kernel's end (a negative
gap is a device timestamp later than the host clock that followed it).
Each gap's least value is printed with its age into the run.  The card's
name and power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

KERNELS = 16


def graph_of_kernels():
    """A captured graph of ``KERNELS`` in-place kernels on one tensor."""
    x = torch.ones(1 << 16, device="cuda")
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            for i in range(KERNELS):
                x.add_(1.0) if i % 2 == 0 else x.mul_(0.5)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(KERNELS):
            x.add_(1.0) if i % 2 == 0 else x.mul_(0.5)
    torch.cuda.synchronize()
    return g


def window(g, calls, margin_s):
    """One profiled window; (graph kernels seen, start gap ns, end gap
    ns)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if margin_s:
            time.sleep(margin_s)
        for _ in range(calls):
            g.replay()
        torch.cuda.synchronize()
        after_ns = time.time_ns()
        if margin_s:
            time.sleep(margin_s)
    res = prof.profiler.kineto_results
    ev = [e for e in res.events()
          if e.device_type() == DeviceType.CUDA and "spin" not in e.name()
          and "elementwise" in e.name()]
    if not ev:
        return 0, None, None
    return (len(ev), min(e.start_ns() for e in ev) - res.trace_start_ns(),
            after_ns - max(e.end_ns() for e in ev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--margin-ms", type=float, default=20.0)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    g = graph_of_kernels()
    want = KERNELS * args.calls
    t0 = time.perf_counter()
    end = t0 + args.minutes * 60
    stats = {f: {"windows": 0, "lost": [], "start": None, "end": None}
             for f in ("bare", "padded")}
    i = 0
    while time.perf_counter() < end:
        form = ("bare", "padded")[i % 2]
        seen, start_gap, end_gap = window(
            g, args.calls, args.margin_ms / 1e3 if form == "padded" else 0)
        age = time.perf_counter() - t0
        st = stats[form]
        st["windows"] += 1
        if seen != want:
            st["lost"].append((round(age, 1), want - seen))
        for key, gap in (("start", start_gap), ("end", end_gap)):
            if gap is not None and (st[key] is None or gap < st[key][0]):
                st[key] = (gap, round(age, 1))
        i += 1
        time.sleep(0.05)
    for form, st in stats.items():
        print(f"{form}: {st['windows']} windows of {want} graph kernels; "
              f"windows with records lost {len(st['lost'])} "
              f"(age s, lost) {st['lost'][:20]}; least start gap "
              f"{st['start'][0]} ns at {st['start'][1]} s; least end gap "
              f"{st['end'][0]} ns at {st['end'][1]} s [{card}]")


if __name__ == "__main__":
    main()

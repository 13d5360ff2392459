"""Runs phases of ``chip_smoke.py`` alone on one GPU, without the other
phases: the ones that take ``(name_card, seed)``, and ``distributed``
(which builds the kernels first: its children load them).

    python3 scripts/torch_smoke_phases.py graphs clustering [--seed 12345]
    python3 scripts/torch_smoke_phases.py distributed

Prints the card's name and power limit, each phase's lines, and the
seconds each phase took; exits non-zero when a check fails or no CUDA
device is available.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

def _distributed(name_card, seed):
    """The distributed phase: its children load the kernels built here."""
    chip_smoke.build_kernels()
    return chip_smoke.distributed_phase(name_card)


PHASES = {"nlp": chip_smoke.nlp_phase, "graphs": chip_smoke.graphs_phase,
          "clustering": chip_smoke.clustering_phase,
          "distributed": _distributed}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="+", choices=sorted(PHASES))
    parser.add_argument("--seed", type=int, default=chip_smoke.NLP_SEED)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    name = chip_smoke.card()
    print(name)
    chip_smoke.pin_fp32_precision()
    for phase in args.phases:
        t0 = time.perf_counter()
        PHASES[phase](name, args.seed)
        torch.cuda.empty_cache()
        print(f"{phase} phase {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A follower rank of a benchmark cell that asks for more than one chip.

    python3 gpubench/follow.py --workload <cell> --seed <n> --control <port>

``gpubench/run.py`` (rank 0) starts one of these for each rank after the
first, with ``torchrun``'s variables set; nobody else needs to.  It
takes the cell from rank 0's control store on ``--control``, builds the
cell's driver on its own device, and makes each call rank 0 announces,
in order, until rank 0 announces the end (``gpubench/ranks.py``).  It
prints no result.
"""

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from gpubench import harness, ranks  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--control", type=int, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()

    import torch

    torch.set_num_threads(2)
    return ranks.follow(args.workload, args.seed, args.control)


if __name__ == "__main__":
    sys.exit(main())

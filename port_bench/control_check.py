"""Read the control of a cell's check at the cell's own size.

    python3 port_bench/control_check.py --workload <cell> --seeds 1 2 3 [--batches N]

For each seed: the cell's collection and reference, the first ``N`` batches
of its window's pool (as a run draws them), the control's answers
(``pbench.control``: every list cut to one window's postings) compared by
the run's own comparison.  Prints one JSON line a seed; the control has to
come out not correct (``mismatched_answers`` above its limit, 0) on every
seed.  Needs neither the program nor a card.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from pbench import collection  # noqa: E402
from pbench.control import control_answers  # noqa: E402
from pbench.reference import Reference, RefIndex  # noqa: E402
from pbench.runner import Cell, compare, load_manifest  # noqa: E402
from pbench.traffic import Traffic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=30)
    args = ap.parse_args(argv)
    cell = Cell.from_manifest(load_manifest(HERE.parent), args.workload, HERE.parent)
    bad = 0
    for seed in args.seeds:
        s = seed % 2**64
        ref = RefIndex(collection.generate(s, **cell.config["collection"]))
        traffic = Traffic(cell.mix, ref.tokens, s)
        batches = [traffic.batch(i) for i in range(1, 1 + args.batches)]
        compared, mismatched, nonempty = compare(batches, control_answers(ref, batches),
                                                 Reference(ref))
        bad += mismatched == 0
        print(json.dumps({"workload": args.workload, "seed": seed, "compared": compared,
                          "nonempty": nonempty, "mismatched_answers": mismatched,
                          "limit": 0, "control_correct": mismatched == 0}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

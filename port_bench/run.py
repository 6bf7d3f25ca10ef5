"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the program is ``src/repro_torch``, the cells
are ``BENCHMARK.json``'s.  Set-up (collection, both index builds, the
session, the query pool, one warm-up batch run twice) is ``setup_s``; then
batches go back to back for ``--seconds``; with ``--trace 1`` a few more
batches run under ``torch.profiler``; last, the plain reference is built from
the documents and every answer is compared with it.  The process pins itself
to one CPU before anything else.  The last line of standard output is the
result object; the numbers compared, each beside its limit, are the last lines of standard
error.  Exits non-zero, printing no result, without a CUDA card, without the
program, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache the program could write stays at a fixed path in the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one client on one host thread: no thread pool competes with the serving loop
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def pin_to_one_cpu() -> int | None:
    """Pin this process, and every thread it starts later, to the last CPU it
    may run on, so that the scheduler never moves the serving loop between
    cores; the CPU, or None where the system has no affinity call."""
    try:
        cpu = max(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpu})
    except (AttributeError, OSError):
        return None
    return cpu


CPU = pin_to_one_cpu()
sys.path.insert(0, str(Path(__file__).resolve().parent))

from pbench.program import ProgramMissing  # noqa: E402
from pbench.runner import Cell, forbidden_modules, load_manifest, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest(ROOT)
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = Cell.from_manifest(manifest, args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result, lines = run_cell(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                                 "cuda", T0)
    except ProgramMissing as e:
        print(str(e), file=sys.stderr)
        return 4
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {sorted(loaded)}: the port and the benchmark may not load "
              f"JAX or the JAX package", file=sys.stderr)
        return 5
    missing = [m["name"] for m in (cell.per_layer if args.trace else cell.end_to_end)
               if m["name"] not in result["metrics"] and not args.trace]
    if missing:
        print(f"end-to-end metrics not measured: {missing}", file=sys.stderr)
        return 6
    print(f"pinned to CPU {CPU}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell several times, one process a run, one after another, and
report each metric's median and quartile spread.

    python3 port_bench/measure.py --workload <cell> --seeds 11 12 13 [--seconds S]
        [--trace 0|1] [--out FILE]

Each run is ``run.py`` as the check runs it; its last line (the result) and
the last lines of its standard error are appended to ``--out`` as JSON
lines.  The spread is (Q3 - Q1) / median with Python's
``statistics.quantiles(values, n=4)``, the rule the bounds are set by.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    rows, failed = [], 0
    for seed in args.seeds:
        cmd = [sys.executable, str(HERE / "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(seconds), "--trace", str(args.trace)]
        t = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        try:
            result = json.loads(last)
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": p.returncode,
               "wall_s": wall, "result": result, "stderr_tail": p.stderr[-3000:]}
        rows.append(row)
        failed += p.returncode != 0 or not (result or {}).get("correct", False)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(row) + "\n")
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"), **brief}), flush=True)
        if p.returncode != 0:
            print(p.stderr[-3000:], file=sys.stderr)
    names = sorted({k for r in rows for k in ((r["result"] or {}).get("metrics") or {})})
    summary = {}
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in rows
                if r["result"] and name in r["result"]["metrics"]]
        summary[name] = {"n": len(vals), "median": statistics.median(vals),
                         "spread": spread(vals), "min": min(vals), "max": max(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary, "failed_runs": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

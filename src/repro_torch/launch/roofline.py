"""Roofline report generator (``repro.launch.roofline``): reads the
dry-run's JSON records (:mod:`.dryrun`) and prints the per-(arch x shape x
mesh) table and a summary, the same text as the reference for the same
records.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir experiments/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_records(directory: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def table(recs: list[dict], mesh_filter: str | None = None) -> str:
    lines = [
        "| arch | shape | mesh | mem/dev GiB | compute | memory | collective | dominant | useful frac | coll GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAIL: {r.get('error','')[:60]} |")
            continue
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['memory']['total_per_device_gib']:.2f} "
            f"| {_fmt_s(rf['compute_s'])} | {_fmt_s(rf['memory_s'])} | {_fmt_s(rf['collective_s'])} "
            f"| **{rf['dominant']}** | {rf['useful_fraction']:.2f} "
            f"| {rf['collective_bytes_per_device']/1e9:.2f} |"
        )
    return "\n".join(lines)


def summary(recs: list[dict]) -> dict:
    ok = [r for r in recs if r.get("status") == "ok"]
    by_dom: dict[str, int] = {}
    for r in ok:
        d = r["roofline"]["dominant"]
        by_dom[d] = by_dom.get(d, 0) + 1
    worst = sorted(
        (r for r in ok if r["roofline"]["useful_fraction"] > 0),
        key=lambda r: r["roofline"]["useful_fraction"])
    most_coll = sorted(
        ok, key=lambda r: -(r["roofline"]["collective_s"] /
                            max(1e-12, r["roofline"]["compute_s"] + r["roofline"]["memory_s"])))
    return {
        "n_ok": len(ok), "n_total": len(recs), "dominant_histogram": by_dom,
        "worst_useful": [(r["arch"], r["shape"], r["mesh"],
                          round(r["roofline"]["useful_fraction"], 3)) for r in worst[:5]],
        "most_collective_bound": [(r["arch"], r["shape"], r["mesh"]) for r in most_coll[:5]],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(table(recs, args.mesh))
    print()
    print(json.dumps(summary(recs), indent=1))


if __name__ == "__main__":
    main()

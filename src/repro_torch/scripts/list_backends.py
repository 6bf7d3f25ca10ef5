"""Print the backend registry as a table.

    PYTHONPATH=src python -m repro_torch.scripts.list_backends
    PYTHONPATH=src python -m repro_torch.scripts.list_backends --family selfindex
    PYTHONPATH=src python -m repro_torch.scripts.list_backends --require persist,seek

``--require`` filters to backends declaring every named capability
(comma-separated); an empty result is an error (exit 2) naming the
missing capabilities, so scripted gates fail loudly.  The registry lives
on the host: no device.
"""

from __future__ import annotations

import argparse
import sys

from ..core.registry import ALL_CAPABILITIES, backend_specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=["inverted", "selfindex"], default=None)
    ap.add_argument("--require", type=str, default=None, metavar="CAP[,CAP...]",
                    help="only backends declaring every named capability")
    args = ap.parse_args(argv)
    specs = backend_specs(family=args.family)
    required = frozenset()
    if args.require:
        required = frozenset(c.strip() for c in args.require.split(",") if c.strip())
        unknown = required - ALL_CAPABILITIES
        if unknown:
            print(f"error: unknown capabilities {sorted(unknown)}; "
                  f"valid: {sorted(ALL_CAPABILITIES)}", file=sys.stderr)
            return 2
        specs = [s for s in specs if required <= s.capabilities]
    if not specs:
        scope = f" in family {args.family!r}" if args.family else ""
        print(f"error: no registered backend{scope} declares "
              f"{sorted(required) if required else 'anything'} — nothing "
              f"matches --require {args.require!r}", file=sys.stderr)
        return 2
    print(f"{'name':16s} {'family':9s} {'group':11s} {'paper':9s} "
          f"{'capabilities':50s} {'build kwargs':18s} description")
    for s in specs:
        caps = ",".join(sorted(s.capabilities)) or "-"
        kw = ",".join(f"{k}={s.defaults.get(k, '?')}" for k in s.build_kwargs) or "-"
        print(f"{s.name:16s} {s.family:9s} {s.group:11s} {s.paper:9s} "
              f"{caps:50s} {kw:18s} {s.doc}")
    print(f"\n{len(specs)} backends"
          + (f" (family={args.family})" if args.family else "")
          + (f" (require={','.join(sorted(required))})" if required else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())

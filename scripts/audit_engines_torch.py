#!/usr/bin/env python
"""CONGEST wire-budget + lint audit over every sharded engine of the port.

Runs each engine on its fixture graph under a recording mesh of
`--shards` shards stacked on one device (the CUDA card unless `--device`
names another), holds every recorded program call to the engine's
declared W-free lane budget, runs the RNG / dtype / elastic-schema lints,
cross-checks the runtime telemetry against the declared widths (unless
`--no-telemetry`), prints the wire-budget table and one line a violation,
and writes the machine-readable report. `--strict` exits 1 on any
violation: the CI gate. The JAX package's scripts/audit_engines.py, through
the launcher's `--audit` (`repro_torch.launch.pagerank.audit`).

Usage:
    PYTHONPATH=src python scripts/audit_engines_torch.py --strict \\
        --out AUDIT.json
    PYTHONPATH=src python scripts/audit_engines_torch.py --device cpu \\
        --shards 8 --engines walks counts
"""
import argparse

from repro_torch.launch.pagerank import audit
from repro_torch.launch.stages import Stages, device_lines, device_or_exit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any violation (CI gate)")
    ap.add_argument("--out", default="AUDIT.json",
                    help="path for the machine-readable report")
    ap.add_argument("--shards", type=int, default=8,
                    help="vertex shards stacked on the device")
    ap.add_argument("--engines", nargs="*", default=None,
                    help="subset of engines (default: all five)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="static checks only (skip the telemetry "
                         "cross-check)")
    ap.add_argument("--eps", type=float, default=0.2)
    ap.add_argument("--walks-per-node", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    stages = Stages(device)

    with stages("audit"):
        report = audit(args.eps, shards=args.shards, device=device,
                       engines=tuple(args.engines) if args.engines else None,
                       out=args.out, run_telemetry=not args.no_telemetry,
                       walks_per_node=args.walks_per_node, strict=False)
    stages.print()
    if args.strict and not report["ok"]:
        raise SystemExit(1)
    return dict(report, **stages.report())


if __name__ == "__main__":
    main()

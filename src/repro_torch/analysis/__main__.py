"""CLI entry point: ``python -m repro_torch.analysis [--strict] [--format
json] [--device cpu]``.

Runs both analyzer families and exits non-zero when the report fails:

- errors always fail;
- warnings fail only under ``--strict`` (the gate runs strict);
- info findings never fail and are hidden from text output unless
  ``--show-info`` is given (they are always present in JSON).

The contract half runs on the card (running, recording and capturing
every cell) unless ``--device cpu`` is given; on the CPU the ``kernel``
backend runs the kernels' plain versions, so it checks the programs
around the kernels.  The concurrency half needs no device.
"""

from __future__ import annotations

import argparse
import sys

from .findings import Report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="program-contract and concurrency analysis for the "
        "port's coded serving stack",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="fail on warnings as well as errors (gate mode)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format on stdout",
    )
    parser.add_argument(
        "--json-out", metavar="PATH", default=None,
        help="also write the JSON report to PATH",
    )
    parser.add_argument(
        "--only", choices=("contracts", "concurrency"), default=None,
        help="run a single analyzer family",
    )
    parser.add_argument(
        "--arch", action="append", default=None,
        help="restrict contract analysis to these CNN archs (repeatable)",
    )
    parser.add_argument(
        "--backend", action="append", default=None,
        choices=("torch", "kernel"),
        help="restrict contract analysis to these backends (repeatable)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device the contract half runs cells on (default cuda; "
        "capture is checked on CUDA only)",
    )
    parser.add_argument(
        "--show-info", action="store_true",
        help="include info-severity findings in text output",
    )
    args = parser.parse_args(argv)

    report = Report()
    if args.only in (None, "concurrency"):
        from . import concurrency

        report.extend(concurrency.run())
    if args.only in (None, "contracts"):
        from . import contracts

        report.extend(contracts.run(
            archs=args.arch,
            backends=tuple(args.backend) if args.backend else contracts.BACKENDS,
            device=args.device))

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(report.to_json())
            fh.write("\n")
    if args.format == "json":
        print(report.to_json())
    else:
        print(report.render_text(show_info=args.show_info))
    return 1 if report.failed(strict=args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one benchmark cell once on this machine's cards and print its result
line (the last line of standard output; the comparison numbers beside their
limits are also the last lines of standard error).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exit codes: 0 with a result line; 2 without one (no card, fewer cards than
the cell asks for, a file of the benchmark missing); 3 when a module of the
JAX package, JAX or ``chip_smoke`` was loaded by the time the window closed.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    args = core.parse_args(argv)

    try:
        cell = core.resolve(args.workload)
        core.require_cards(cell.chips)
        line, checks, _ = core.runner(cell).run(cell, args, T0)
    except core.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    print(line, flush=True)
    for text in checks.lines():
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

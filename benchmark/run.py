"""Run one cell of the benchmark of `ddgan_torch` once, on the card(s) of
this machine, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the result holds the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, read from a profiled slice after the
window, and a breakdown of device time and idle gaps. Every run checks
what its timed path produced against the plain reference
(`benchmark/reference/`) and prints each number compared beside its limit,
as the last lines of standard error and under "checks" in the result.
Without a CUDA card, or with fewer than the cell asks for, it exits with
code 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def bootstrap() -> None:
    """Import from the checkout's root, and keep the build and kernel caches
    of whatever the run compiles at fixed paths in the checkout (the port's
    own nvcc libraries live in ddgan_torch/_build/)."""
    sys.path[0] = str(ROOT)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / "_cache" / "torch_extensions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    banned = harness.banned_modules()
    if banned:
        print(f"modules that no run may load are loaded: {', '.join(banned)}", file=sys.stderr)
        return 4
    line = harness.result_line(out)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    bootstrap()
    sys.exit(main())

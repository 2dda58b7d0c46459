"""The readings that the limits of `benchmark/limits/<cell>.json` are set
from, on the card at the cell's own size; not run by the benchmark's runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--faults] [--seconds <s>]

For each seed of `--seeds` it builds the program as a run does (a sample
cell also runs a window of `--seconds`), takes the readings the check
compares and runs the check: the lower readings. For each seed of
`--control-seeds` it puts the plain reference, computed in float8 (the
precision below the configurations' bfloat16), in the program's place and
compares it with the float32 reference: the control, which sets the upper
readings. With `--faults` it plants each fault of `benchmark/faults.py` on
the first control seed. One JSON line a reading on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def program_numbers(cell, mix, seed: int, seconds: float) -> dict:
    program = mix.Program(cell, seed, "cuda")
    if cell.traffic["kind"] == "sample":
        program.window(seconds)
    readings = program.readings()
    program.close()
    del program
    _free()
    if cell.traffic["kind"] == "train":
        ref = mix.reference_readings(cell, seed, "cuda")
        numbers = mix.compare(readings, ref)
        numbers["losses"] = {"program": readings["losses"], "reference": ref["losses"]}
        numbers["worst"] = mix.worst_leaves(readings, ref)
        return numbers
    return {k: c["value"] for k, c in mix.check(cell, seed, "cuda", readings).items()}


def control_numbers(cell, mix, seed: int) -> dict:
    from benchmark.weights import generator

    if cell.traffic["kind"] == "train":
        ref = mix.reference_readings(cell, seed, "cuda")
        _free()
        ctl = mix.reference_readings(cell, seed, "cuda", precision="fp8")
        numbers = mix.compare(ctl, ref)
        numbers["losses"] = {"control": ctl["losses"], "reference": ref["losses"]}
        numbers["worst"] = mix.worst_leaves(ctl, ref)
        return numbers
    states = [generator(seed, f"call{k}", "cuda").get_state()
              for k in range(int(cell.traffic["check_calls"]))]
    ref = mix.reference_images(cell, seed, "cuda", states)
    ctl = mix.reference_images(cell, seed, "cuda", states, precision="fp8")
    return {"image": mix.image_gap(ctl, ref)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()

    from benchmark import faults, harness

    cell = harness.load_cell(args.workload)
    mix = harness.mix_module(cell)

    def emit(kind, seed, numbers, t0):
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "numbers": numbers,
                          "s": round(time.perf_counter() - t0, 2)}), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        emit("program", seed, program_numbers(cell, mix, seed, args.seconds), t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        emit("control", seed, control_numbers(cell, mix, seed), t0)
        _free()
    if args.faults and args.control_seeds:
        table = faults.TRAIN if cell.traffic["kind"] == "train" else faults.SAMPLE
        for name, fault in table.items():
            seed = args.control_seeds[0]
            t0 = time.perf_counter()
            with fault():
                numbers = program_numbers(cell, mix, seed, args.seconds)
            emit(f"fault:{name}", seed, numbers, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

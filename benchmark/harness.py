"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything a cell needs is found by name. `BENCHMARK.json` names the cell's
configuration (whose file holds the keys of `ddgan_torch.config.Config`)
and its traffic mix, `benchmark/traffic/<mix>.json`, whose `kind` names
the generator that reads it, `benchmark/mixes/<kind>.py`. The numbers that
decide `correct` are held to `benchmark/limits/<cell>.json`. A per-layer
metric `<name>.<suffix>` is read by `benchmark/metrics/<name>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "optax", "ddgan_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic mix
    limits: dict  # number compared -> limit
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list

    @property
    def cfg(self) -> dict:
        """The keys handed to `ddgan_torch.config.Config`."""
        return self.config["config"]

    @property
    def batch(self) -> int:
        return int(self.traffic.get("batch") or self.cfg["batch_size"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def mix_module(cell: Cell):
    return importlib.import_module(f"benchmark.mixes.{cell.traffic['kind']}")


def read_per_layer(cell: Cell, ctx) -> dict:
    """Each per-layer metric its reader finds something for."""
    out = {}
    for m in cell.per_layer:
        base, _, suffix = m["name"].partition(".")
        reader = importlib.import_module(f"benchmark.metrics.{base}")
        value = reader.read(ctx, suffix)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def banned_modules() -> list[str]:
    return sorted({k.partition(".")[0] for k in sys.modules} & set(BANNED))


def device_info(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """Set up, measure, trace and check one run; the result line's object
    (without `device`) and the checks."""
    import torch

    mix = mix_module(cell)
    t_program = time.perf_counter()
    program = mix.Program(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    parts = {"before_program_s": t_program - t_start, **program.setup_parts}
    print(f"setup: {json.dumps(parts)}", file=sys.stderr)
    metrics = program.window(seconds)
    metrics["setup_s"] = setup_s
    e2e = {m["name"]: {"value": float(metrics[m["name"]]), "unit": m["unit"]}
           for m in cell.end_to_end}
    out = {"attempted": program.attempted, "failed": 0, "metrics": e2e}
    if trace:
        ctx = program.trace()
        out["metrics"] = read_per_layer(cell, ctx)
        out["trace"] = ctx
    if device == "cuda":
        torch.cuda.synchronize()
        out["device"] = device_info(cell.chips, program.peak_bytes())
    readings = program.readings()
    program.close()
    del program
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["checks"] = mix.check(cell, seed, device, readings)
    print(f"check: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    return out


def verdict(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(out: dict) -> dict:
    """The result's keys, with the numbers compared last."""
    line = {"correct": verdict(out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"], "device": out["device"]}
    if "trace" in out:
        ctx = out["trace"]
        line["device"] = {**line["device"], "busy_s": ctx.trace.busy_s,
                          "window_s": ctx.trace.window_s}
        line["breakdown"] = ctx.trace.breakdown()
    line["checks"] = out["checks"]
    return line

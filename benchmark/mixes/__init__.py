"""The generators of the traffic mixes, one module a `kind`.

Each module has a `Program(cell, seed, device)` (its constructor is the
run's set-up; then `window(seconds)` -> end-to-end metrics, `trace()` ->
a `Reading` for the per-layer readers, `readings()` -> what the check
compares, `close()`, and `attempted`) and a `check(cell, seed, device,
readings)` that runs the plain reference and returns each number compared
with its limit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Reading:
    """What the per-layer readers read (`benchmark/metrics/`)."""

    kind: str  # the mix's kind: "train" or "sample"
    trace: object  # benchmark.trace.TraceSummary of the profiled slice
    rate: float  # the window's samples (or images) per second
    window: dict  # other readings of the window (spans, peak memory)
    work: object  # benchmark.work.flops.UnitWork of the profiled slice
    flops_per_item: float  # model FLOPs per sample or image


def port_config(cell):
    """The cell's configuration as the port's `Config`."""
    from ddgan_torch.config import Config

    return Config.from_dict(cell.cfg)


def build_kernels(cfg) -> None:
    """Build (or load from `ddgan_torch/_build/`) the hand-written kernels
    the configuration runs: the FIR resample always, the gated conv in
    bfloat16 at 128² and more."""
    from ddgan_torch.ops import fir2x, pair_conv

    fir2x.build()
    if str(cfg.compute_dtype) in ("bfloat16", "bf16") and cfg.image_size >= 128:
        pair_conv.build()


def leaf_gaps(prog: list, ref: list, keep: list | None = None) -> list:
    """Each leaf's gap between two lists of per-leaf norms: |p - r| over the
    larger of r and the median of the reference's norms; only the leaves
    where `keep` is true, when given."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = sorted(ref[i] for i in idx)[len(idx) // 2]
    return [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx]


def median(values: list) -> float:
    return sorted(values)[len(values) // 2]

"""What a run loads: no JAX and no JAX package anywhere in a run's process,
and nothing of the program in the plain reference's. Module names are
compared by their top-level name (before the first dot), whole: the port's
name begins with the JAX package's."""

import json
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "optax", "ddgan_tpu"}

RUN = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import benchmark.run
from benchmark import harness
from conftest import tiny_cell
for name in ("cifar10.train", "cifar10.sample"):
    harness.run(tiny_cell(name), 3, 0.2, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.nets, benchmark.reference.train, benchmark.reference.diffusion
import benchmark.work.flops
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    src = code.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN)
    assert "ddgan_torch" in loaded and "benchmark" in loaded
    assert not loaded & BANNED, loaded & BANNED


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (BANNED | {"ddgan_torch"}), loaded & (BANNED | {"ddgan_torch"})

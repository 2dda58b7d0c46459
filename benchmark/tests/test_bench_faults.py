"""Each fault a cell can have, planted underneath the timed path, makes the
rest of a run come out not correct under the cell's committed limits,
while the same run without a fault comes out correct; and the control, the
reference computed in float8 in the program's place, fails at least one of
a cell's numbers. Tiny sizes on the CPU, the program in float32 (so that a
sound run reads nought but rounding)."""

import time

import pytest

from conftest import tiny_cell

SEEDS = (2**31 + 99, 2**31 + 100, 2**31 + 101)


def _run(name, fault=None):
    from benchmark import harness

    cell = tiny_cell(name, compute_dtype="float32")
    if fault is None:
        out = harness.run(cell, SEEDS[0], 0.3, False, "cpu", time.perf_counter())
    else:
        with fault():
            out = harness.run(cell, SEEDS[0], 0.3, False, "cpu", time.perf_counter())
    return harness.verdict(out["checks"]), out["checks"]


@pytest.mark.parametrize("name", ["cifar10.train", "cifar10.sample"])
def test_a_sound_run_comes_out_correct(name):
    ok, checks = _run(name)
    assert ok, checks


@pytest.mark.parametrize("name,fault", [("cifar10.train", "unchanged"),
                                        ("cifar10.train", "half_batch"),
                                        ("cifar10.sample", "altered"),
                                        ("cifar10.sample", "half_batch")])
def test_a_fault_comes_out_not_correct(name, fault):
    from benchmark import faults

    table = faults.TRAIN if name.endswith("train") else faults.SAMPLE
    ok, checks = _run(name, table[fault])
    assert not ok, checks


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["cifar10.train", "celeba256.train"])
def test_the_control_fails_a_train_cell(name, seed):
    from benchmark.mixes import train

    cell = tiny_cell(name)
    numbers = train.compare(train.reference_readings(cell, seed, "cpu", precision="fp8"),
                            train.reference_readings(cell, seed, "cpu"))
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["cifar10.sample", "celeba256.sample"])
def test_the_control_fails_a_sample_cell(name, seed):
    from benchmark.mixes import sample
    from benchmark.weights import generator

    cell = tiny_cell(name)
    states = [generator(seed, f"call{k}", "cpu").get_state() for k in range(2)]
    gap = sample.image_gap(sample.reference_images(cell, seed, "cpu", states, precision="fp8"),
                           sample.reference_images(cell, seed, "cpu", states))
    assert gap > cell.limits["image"], gap

"""The plain reference against the port's plain path, at tiny sizes on the
CPU: the same weights by name, the same forwards, and a whole run of each
mix in float32 (the program then agrees with the reference to rounding)."""

import time

import pytest
import torch

from conftest import tiny_cell

SIX_LEVELS = dict(image_size=64, ch_mult=[1, 1, 2, 2, 4, 4], disc_small="no",
                  num_timesteps=2)


def _models(cell):
    from ddgan_torch import models
    from ddgan_torch.config import Config

    from benchmark.reference import nets

    cfg = Config.from_dict(cell.cfg)
    return ((models.NCSNpp.from_config(cfg), nets.Generator(cell.cfg)),
            (models.build_discriminator(cfg), nets.Discriminator(cell.cfg)))


@pytest.mark.parametrize("over", [{}, SIX_LEVELS], ids=["flagship", "six_levels"])
def test_parameters_match_the_port_by_name_and_shape(over):
    for port, ref in _models(tiny_cell("cifar10.train", compute_dtype="float32", **over)):
        assert {k: tuple(p.shape) for k, p in port.named_parameters()} == {
            k: tuple(p.shape) for k, p in ref.named_parameters()}


@pytest.mark.parametrize("over", [{}, SIX_LEVELS], ids=["flagship", "six_levels"])
def test_forwards_match_the_port(over):
    from benchmark.reference.ops import Ops
    from benchmark.weights import fill_weights

    cell = tiny_cell("cifar10.train", compute_dtype="float32", dropout=0.0, **over)
    (pg, rg), (pd, rd) = _models(cell)
    for m, tag in ((pg, "G"), (rg, "G"), (pd, "D"), (rd, "D")):
        fill_weights(m, 5, tag)
    c = cell.cfg
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, c["image_size"], c["image_size"], generator=g)
    x2 = torch.randn(x.shape, generator=g)
    t = torch.randint(0, c["num_timesteps"], (4,), generator=g)
    z = torch.randn(4, c["nz"], generator=g)
    ops = Ops()
    with torch.no_grad():
        torch.testing.assert_close(rg.eval()(ops, x, t, z), pg.eval()(x, t, z), rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(rd(ops, x, t, x2), pd(x, t, x2).reshape(-1), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["cifar10.train", "cifar10.sample"])
def test_a_float32_run_agrees_with_the_reference(name):
    from benchmark import harness

    cell = tiny_cell(name, compute_dtype="float32")
    out = harness.run(cell, 2**31 + 77, 0.5, False, "cpu", time.perf_counter())
    assert out["attempted"] > 0
    for k, c in out["checks"].items():
        assert c["value"] < 1e-4, (k, c)


def test_chunked_reference_step_equals_the_whole_batch():
    from benchmark.mixes import train

    whole = tiny_cell("cifar10.train")
    chunked = tiny_cell("cifar10.train")
    chunked.config["reference_rows"] = 4
    a = train.reference_readings(whole, 9, "cpu")
    b = train.reference_readings(chunked, 9, "cpu")
    numbers = train.compare(b, a)
    assert max(numbers.values()) < 1e-4, numbers

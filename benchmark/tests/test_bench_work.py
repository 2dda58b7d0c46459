"""The counts of work against hand counts and against the port's own
counts of its kernels' calls."""

import json

import pytest
import torch

from conftest import ROOT, tiny_cell


def _cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())["config"]


@pytest.mark.parametrize("r1", [True, False])
@pytest.mark.parametrize("name,n_d,n_g", [("cifar10", 3, 3), ("celeba256", 6, 5)])
def test_fir_calls_by_role_follow_the_step(name, n_d, n_g, r1):
    from benchmark.work import flops, kernels

    work = flops.train_step_work(_cfg(name), 4, r1)
    assert work.fir_roles == kernels.expected_fir_calls(n_d, n_g, r1, shared=True)


def test_gated_convs_of_the_256_recipe():
    from benchmark.work import flops

    # 23 gated convs a G forward; in the G update 18 input gradients go
    # through K2 (C_in 64) and 5 to the library (C_in 128)
    assert flops.train_step_work(_cfg("celeba256"), 4, True).pair_conv_roles == {
        "forward": 46, "dx": 18, "dx_library": 5}
    assert flops.sample_call_work(_cfg("celeba256"), 4).pair_conv_roles == {
        "forward": 46, "dx": 0, "dx_library": 0}
    assert flops.sample_call_work(_cfg("cifar10"), 4).pair_conv_roles["forward"] == 0


class _Tally:
    """Ops that also count, by the textbook formula, 2 x multiply-adds of
    every conv, linear map and matmul."""

    def __init__(self):
        from benchmark.reference.ops import Ops

        self.ops, self.flops = Ops(), 0

    def __getattr__(self, name):
        return getattr(self.ops, name)

    def conv2d(self, x, w, b=None, stride=1, padding=0, gated=False):
        y = self.ops.conv2d(x, w, b, stride, padding, gated)
        self.flops += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def conv_down2x(self, x, w, b, k=(1, 3, 3, 1)):
        from benchmark.reference.ops import fir_taps, upfirdn2d

        return self.conv2d(upfirdn2d(x, fir_taps(k, 1.0), 1, 1, 2, 2), w, b, stride=2)

    def linear(self, x, w, b=None):
        self.flops += 2 * x.numel() // x.shape[-1] * w.shape[0] * w.shape[1]
        return self.ops.linear(x, w, b)

    def matmul(self, a, b):
        self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[-1]
        return self.ops.matmul(a, b)

    def matmul_f32(self, a, b):
        self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[-1]
        return self.ops.matmul_f32(a, b)


def test_generator_flops_against_a_hand_count():
    from benchmark.reference import diffusion, nets
    from benchmark.work import flops

    cfg = tiny_cell("cifar10.sample").cfg
    G = nets.Generator(cfg).eval()
    for p in G.parameters():
        torch.nn.init.normal_(p)
    tally = _Tally()
    sched = diffusion.Schedule(cfg["num_timesteps"], cfg["beta_min"], cfg["beta_max"], "cpu")
    diffusion.sample(sched, G, tally, (2, 3, 16, 16), cfg["nz"], None)
    assert tally.flops > 0
    assert flops.sample_call_work(cfg, 2).flops == tally.flops


def test_bounds_against_hand_counts():
    from benchmark.work import kernels, peaks

    # down2x of 2x64 planes of 128x128 in bf16: bytes (in + out) bound it
    n = 2 * 64
    assert kernels.fir_bound_s("down2x", (2, 64, 128, 128)) == pytest.approx(
        n * (128 * 128 + 64 * 64) * 2 / peaks.HBM_BYTES_PER_S)
    assert kernels.fir_bound_s("up2x", (2, 64, 64, 64)) == pytest.approx(
        n * (64 * 64 + 128 * 128) * 2 / peaks.HBM_BYTES_PER_S)
    # K2 at 4 x 64 x 256 x 256: x and y (bf16) just outweigh its operations;
    # at C_in 128 the operations bound it
    px = 4 * 256 * 256
    assert kernels.pair_bound_s((4, 64, 256, 256)) == pytest.approx(
        (px * 64 * 2 * 2 + 64 * 64 * 9 * 2 + 64 * 4) / peaks.HBM_BYTES_PER_S)
    assert kernels.pair_bound_s((4, 128, 256, 256)) == pytest.approx(
        2 * px * 64 * 9 * 128 / peaks.BF16_FLOPS)
    assert kernels.gated((4, 64, 256, 256), (64, 64, 3, 3))
    assert not kernels.gated((4, 64, 256, 256), (128, 64, 3, 3))
    assert not kernels.gated((4, 64, 64, 64), (64, 64, 3, 3))

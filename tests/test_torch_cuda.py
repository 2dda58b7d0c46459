"""The CUDA kernels (fir2x, pair_conv3x3) against their plain PyTorch
versions, on the GPU.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one. They import neither JAX nor the JAX package, so on a GPU
machine without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

fir2x: shapes go beyond the flagship's (which `chip_smoke.py` checks) to
partial output tiles, odd output sizes and blocks that hold several planes.
Tolerances: max-abs 1e-5 in float32 (the same f32 sums in another order,
TF32 off), 2e-2 of max|ref| in bfloat16 (one rounding of the output).

pair_conv3x3: the four shapes of the 256x256 generator's gated convs at
batch 16, and shapes with a partial channel chunk and a partial column
tile. Both sides sum in f32 (TF32 off) and round once to bf16, so they
differ by at most one bf16 rounding step: max-abs <= 1 ulp of max|ref|.
"""

import numpy as np
import pytest
import torch

from ddgan_torch.nn.layers import Conv3x3
from ddgan_torch.ops import fir2x, pair_conv, resample

FIR = (1.0, 3.0, 3.0, 1.0)
FIR_ASYM = (1.0, 2.0, 3.0, 4.0)
SHAPES = [(3, 16, 8, 12), (2, 3, 38, 22), (1, 2, 70, 66), (5, 61, 8, 8), (1, 37, 4, 4)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _taps(fir, factor=1):
    k = np.asarray(fir, np.float64)
    return tuple((k / k.sum() * factor).tolist())


def _randn(shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
def test_kernel_matches_plain(cuda_device, shape, dtype, fir):
    x = _randn(shape).to(cuda_device, dtype)
    for fn, ref, k, name in ((fir2x.down2x, fir2x.down2x_ref, _taps(fir), "down2x"),
                             (fir2x.up2x, fir2x.up2x_ref, _taps(fir, 2), "up2x")):
        before = fir2x.LAUNCHES[name]
        with torch.no_grad():
            got, want = fn(x, k), ref(x.float(), k)
        torch.cuda.synchronize()
        assert fir2x.LAUNCHES[name] == before + 1
        assert got.dtype == dtype and got.shape == want.shape
        bound = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
        assert (got.float() - want).abs().max().item() <= bound


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = _randn((2, 3, 8, 8)).to(cuda_device)
    k = _taps(FIR)
    before = dict(fir2x.LAUNCHES)
    with pytest.raises(TypeError):
        fir2x.down2x(x.half(), k)
    with pytest.raises(ValueError, match="even"):
        fir2x.down2x(x[:, :, :7].contiguous(), k)
    with pytest.raises(ValueError, match="contiguous"):
        fir2x.up2x(x.transpose(2, 3), k)
    with pytest.raises(ValueError, match="4 taps"):
        fir2x.up2x(x, k[:3])
    with pytest.raises(RuntimeError, match="forward only"):
        fir2x.up2x(x.clone().requires_grad_(), k)
    assert fir2x.LAUNCHES == before


@pytest.mark.cuda
def test_resample_layer_dispatches_to_the_kernel(cuda_device):
    x = _randn((2, 8, 16, 16), seed=1)
    for fn, name in ((resample.upsample_2d, "up2x"), (resample.downsample_2d, "down2x")):
        before = fir2x.LAUNCHES[name]
        with torch.no_grad():
            got = fn(x.to(cuda_device), list(FIR), factor=2)
        assert fir2x.LAUNCHES[name] == before + 1
        want = fn(x, list(FIR), factor=2)
        assert (got.cpu() - want).abs().max().item() <= 1e-5
        # outside the kernel's domain (2 taps) the plain path runs on the GPU too
        with torch.no_grad():
            fn(x.to(cuda_device), [1, 1], factor=2)
        assert fir2x.LAUNCHES[name] == before + 1


PAIR_PATH_SHAPES = [(16, 64, 256, 256), (16, 128, 256, 256), (16, 64, 128, 128),
                    (16, 128, 128, 128)]
PAIR_EDGE_SHAPES = [(2, 64, 128, 128), (1, 34, 128, 128), (3, 2, 160, 160), (1, 96, 224, 224)]


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _pair_inputs(shape, seed, device):
    n, c, h, w = shape
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(n, c, h, w).astype(np.float32)).to(device, torch.bfloat16)
    wt = torch.from_numpy((rs.randn(64, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)).to(device)
    b = torch.from_numpy(rs.randn(64).astype(np.float32)).to(device)
    return x, wt, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAIR_PATH_SHAPES + PAIR_EDGE_SHAPES)
def test_pair_conv_matches_plain(cuda_device, shape):
    x, wt, b = _pair_inputs(shape, sum(shape), cuda_device)
    before = pair_conv.LAUNCHES["pair_conv3x3"]
    with torch.no_grad():
        got = pair_conv.pair_conv3x3(x, wt, b)
        want = pair_conv.pair_conv3x3_ref(x, wt, b)
    torch.cuda.synchronize()
    assert pair_conv.LAUNCHES["pair_conv3x3"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], 64) + shape[2:]
    scale = want.float().abs().max().item()
    assert scale > 0.5
    assert (got.float() - want.float()).abs().max().item() <= _bf16_ulp(scale)


@pytest.mark.cuda
def test_pair_conv_refuses_what_the_kernel_does_not_take(cuda_device):
    x, wt, b = _pair_inputs((1, 64, 128, 128), 0, cuda_device)
    before = pair_conv.LAUNCHES["pair_conv3x3"]
    bad = [
        (x.float(), wt, b),                                  # f32
        (x[:, :, :96, :96].contiguous(), wt, b),             # 96 < 128
        (x, torch.cat([wt, wt]), b),                         # C_out 128
        (x.transpose(2, 3), wt, b),                          # not contiguous
        (x, wt[:, :, :2], b),                                # 3x2 kernel
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pair_conv.pair_conv3x3(*args)
    with pytest.raises(RuntimeError, match="forward only"):
        pair_conv.pair_conv3x3(x, wt.clone().requires_grad_(), b)
    assert pair_conv.LAUNCHES["pair_conv3x3"] == before


@pytest.mark.cuda
def test_conv3x3_dispatches_to_the_kernel(cuda_device):
    torch.manual_seed(0)
    gated = Conv3x3(64, 64, dtype=torch.bfloat16).to(cuda_device)
    other = Conv3x3(64, 32, dtype=torch.bfloat16).to(cuda_device)
    x = _randn((2, 64, 128, 128), seed=2).to(cuda_device)
    before = pair_conv.LAUNCHES["pair_conv3x3"]
    with torch.no_grad():
        got = gated(x)
        other(x)
        gated(x[:, :, :64, :64].contiguous())
    assert pair_conv.LAUNCHES["pair_conv3x3"] == before + 1
    with torch.no_grad():
        want = pair_conv.pair_conv3x3_ref(x, gated.weight, gated.bias)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= _bf16_ulp(scale)

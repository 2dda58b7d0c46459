"""The fir2x CUDA kernel against its plain PyTorch version, on the GPU.

These tests need an NVIDIA GPU with nvcc (the kernel has no CPU mode) and
skip without one. They import neither JAX nor the JAX package, so on a GPU
machine without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Shapes go beyond the flagship's (which `chip_smoke.py` checks) to partial
output tiles, odd output sizes and blocks that hold several planes.
Tolerances: max-abs 1e-5 in float32 (the same f32 sums in another order,
TF32 off), 2e-2 of max|ref| in bfloat16 (one rounding of the output).
"""

import numpy as np
import pytest
import torch

from ddgan_torch.ops import fir2x, resample

FIR = (1.0, 3.0, 3.0, 1.0)
FIR_ASYM = (1.0, 2.0, 3.0, 4.0)
SHAPES = [(3, 16, 8, 12), (2, 3, 38, 22), (1, 2, 70, 66), (5, 61, 8, 8), (1, 37, 4, 4)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fir2x kernel has no CPU mode")
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

"""FIR ops of the port (`ddgan_torch.ops`) against the JAX package.

upfirdn2d_ref against the JAX XLA reference over up/down/pad/kernel size;
the 2x patterns (plain versions, and the wrappers on CPU tensors) against
the Pallas `down2x` / `up2x` in interpret mode, with the symmetric flagship
taps and asymmetric taps that catch a missing flip; the resample layer
against `ddgan_tpu.ops.resample`. Tolerance rtol 1e-5 / atol 1e-6: the
same f32 sums in another order. The CUDA kernel itself is compared with
its plain version in `test_torch_cuda.py`, which needs a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddgan_tpu.ops import resample as jresample
from ddgan_tpu.ops.experimental.pallas_upfirdn import down2x as jdown2x
from ddgan_tpu.ops.experimental.pallas_upfirdn import up2x as jup2x
from ddgan_tpu.ops.upfirdn2d import upfirdn2d_ref as jupfirdn2d_ref

from ddgan_torch.ops import fir2x, resample
from ddgan_torch.ops.upfirdn2d import upfirdn2d_ref

from _torch_port import nchw, nhwc, randn

FIR = np.array([1.0, 3.0, 3.0, 1.0])
FIR_ASYM = np.array([1.0, 2.0, 3.0, 4.0])
TOL = dict(rtol=1e-5, atol=1e-6)


def _k1d(fir, factor=1):
    return tuple((fir / fir.sum() * factor).tolist())


@pytest.mark.parametrize(
    "up,down,pad,ksize",
    [(1, 2, (1, 1), 4), (2, 1, (2, 1), 4), (1, 1, (2, 2), 4), (2, 2, (1, 0), 3),
     (1, 2, (0, -1), 2), (2, 1, (1, 1, 2, 0), 4)],
)
def test_upfirdn2d_ref_matches_jax(up, down, pad, ksize):
    x = randn(0, 2, 9, 8, 3)
    k = np.random.RandomState(1).rand(ksize, ksize).astype(np.float32)
    want = np.asarray(jupfirdn2d_ref(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad))
    got = upfirdn2d_ref(nchw(x), torch.from_numpy(k), up=up, down=down, pad=pad)
    assert got.shape == nchw(want).shape
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 16, 8, 128), (2, 4, 6, 5)])
def test_down2x_matches_pallas(fir, shape):
    x = randn(2, *shape)
    want = np.asarray(jdown2x(jnp.asarray(x), _k1d(fir)))
    for fn in (fir2x.down2x_ref, fir2x.down2x):
        np.testing.assert_allclose(nhwc(fn(nchw(x), _k1d(fir))), want, **TOL)


@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 8, 16, 128), (2, 4, 4, 5)])
def test_up2x_matches_pallas(fir, shape):
    x = randn(3, *shape)
    want = np.asarray(jup2x(jnp.asarray(x), _k1d(fir, factor=2)))
    for fn in (fir2x.up2x_ref, fir2x.up2x):
        np.testing.assert_allclose(nhwc(fn(nchw(x), _k1d(fir, factor=2))), want, **TOL)


@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
def test_resample_matches_jax(fir):
    x = randn(4, 2, 8, 8, 4)
    k = fir.tolist()
    for jfn, fn in ((jresample.upsample_2d, resample.upsample_2d),
                    (jresample.downsample_2d, resample.downsample_2d)):
        want = np.asarray(jfn(jnp.asarray(x), k, factor=2))
        np.testing.assert_allclose(nhwc(fn(nchw(x), k, factor=2)), want, **TOL)
    np.testing.assert_allclose(
        nhwc(resample.naive_upsample_2d(nchw(x))),
        np.asarray(jresample.naive_upsample_2d(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        nhwc(resample.naive_downsample_2d(nchw(x))),
        np.asarray(jresample.naive_downsample_2d(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_fused_conv_resample_matches_jax(kind):
    x = randn(5, 2, 8, 8, 3)
    w_hwio = randn(6, 3, 3, 3, 5)
    w_oihw = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    if kind == "up":
        want = jresample.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w_hwio), k=FIR.tolist())
        got = resample.upsample_conv_2d(nchw(x), w_oihw, k=FIR.tolist())
    else:
        want = jresample.conv_downsample_2d(jnp.asarray(x), jnp.asarray(w_hwio), k=FIR.tolist())
        got = resample.conv_downsample_2d(nchw(x), w_oihw, k=FIR.tolist())
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_setup_kernel_matches_jax():
    for k in ([1, 3, 3, 1], [1, 2, 3, 4], [[1, 2], [3, 4]]):
        np.testing.assert_allclose(resample.setup_kernel(k), jresample.setup_kernel(k), **TOL)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 4, 4, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        fir2x.down2x(x, _k1d(FIR))
    with pytest.raises(RuntimeError, match="CUDA"):
        fir2x.up2x(x, _k1d(FIR))
    assert fir2x.LAUNCHES == {"down2x": 0, "up2x": 0}


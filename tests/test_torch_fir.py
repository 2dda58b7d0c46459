"""FIR ops of the port (`ddgan_torch.ops`) against the JAX package.

upfirdn2d_ref against the JAX XLA reference over up/down/pad/kernel size;
the 2x patterns (plain versions, and the wrappers on CPU tensors) against
the Pallas `down2x` / `up2x` in interpret mode, with the symmetric flagship
taps and asymmetric taps that catch a missing flip; the resample layer
against `ddgan_tpu.ops.resample`. Tolerance rtol 1e-5 / atol 1e-6: the
same f32 sums in another order. The wrappers' autograd (the other
pattern with the taps reversed, differentiable in turn) against `jax.grad`
through the Pallas functions to first and second order (rtol 1e-4 / atol
1e-5, as `tests/test_pallas_fir.py`), and by `gradcheck` / `gradgradcheck`
in float64. The CUDA kernel itself is compared with its plain version in
`test_torch_cuda.py`, which needs a GPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddgan_tpu.ops import resample as jresample
from ddgan_tpu.ops.experimental.pallas_upfirdn import down2x as jdown2x
from ddgan_tpu.ops.experimental.pallas_upfirdn import up2x as jup2x
from ddgan_tpu.ops.upfirdn2d import upfirdn2d_ref as jupfirdn2d_ref

from ddgan_torch.ops import fir2x, resample
from ddgan_torch.ops.upfirdn2d import upfirdn2d_ref

from _torch_port import nchw, nhwc, one_torch_thread, randn  # noqa: F401 (autouse)

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
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 8, 16, 128), (2, 4, 4, 5), (1, 3, 5, 4),
                                   (2, 5, 3, 3)])
def test_up2x_matches_pallas(fir, shape):
    """Odd sides too: the JAX `up2x` takes them, and so does the kernel."""
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


def test_upfirdn2d_copies_a_host_kernel_to_a_device_once():
    """A host kernel bound for another device than the CPU is copied there
    on its first use and reused (a CUDA graph's capture may not copy from
    pageable host memory); each content, device and dtype has its own copy,
    and a CPU input takes the kernel as given."""
    from ddgan_torch.ops import upfirdn2d

    k = np.outer(FIR, FIR).astype(np.float32)
    x = torch.empty((1, 2, 8, 8), device="meta")
    first = upfirdn2d._kernel_on(k, x)
    assert first.device.type == "meta" and first.shape == (4, 4)
    assert upfirdn2d._kernel_on(k.copy(), x) is first
    assert upfirdn2d._kernel_on(torch.from_numpy(k), x) is first
    assert upfirdn2d._kernel_on(k * 2, x) is not first
    assert upfirdn2d._kernel_on(k, x.to(torch.bfloat16)).dtype == torch.bfloat16
    assert upfirdn2d_ref(x, k, down=2, pad=(1, 1)).shape == (1, 2, 4, 4)
    on_cpu = upfirdn2d._kernel_on(k, torch.zeros(1))
    assert on_cpu.device.type == "cpu" and torch.equal(on_cpu, torch.from_numpy(k))


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



_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# case -> (pattern, NHWC input shape, taps' factor, NHWC shape for the f64
# checks); the ports and the JAX functions by pattern
_PATTERNS = {
    "down2x": ("down2x", (1, 8, 8, 3), 1, (1, 4, 4, 2)),
    "up2x": ("up2x", (1, 4, 6, 3), 2, (1, 2, 4, 2)),
    # output 3 x 5: the VJP is an up2x of odd sides
    "down2x_odd_out": ("down2x", (1, 6, 10, 3), 1, (1, 6, 2, 1)),
}
_FNS = {"down2x": (fir2x.down2x, jdown2x), "up2x": (fir2x.up2x, jup2x)}


@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("case", sorted(_PATTERNS))
def test_gradients_match_pallas_to_second_order(case, fir):
    """As `tests/test_pallas_fir.py::test_down2x_gradients_match_xla`: the
    grad of sum(f(x)^2), and the grad of the squared norm of that grad (the
    R1 grad-of-grad), against `jax.grad` through the Pallas function."""
    name, shape, factor, _ = _PATTERNS[case]
    fn, jfn = _FNS[name]
    x = randn(3, *shape)
    k = _k1d(fir, factor)

    def j_loss(v):
        return (jfn(v, k) ** 2).sum()

    def j_r1(v):
        return (jax.grad(j_loss)(v) ** 2).sum()

    fir2x.reset_launch_counts()
    xt = nchw(x).requires_grad_(True)
    (g,) = torch.autograd.grad((fn(xt, k) ** 2).sum(), xt, create_graph=True)
    np.testing.assert_allclose(nhwc(g), np.asarray(jax.grad(j_loss)(jnp.asarray(x))),
                               **_GRAD_TOL)
    (gg,) = torch.autograd.grad((g**2).sum(), xt)
    np.testing.assert_allclose(nhwc(gg), np.asarray(jax.grad(j_r1)(jnp.asarray(x))),
                               **_GRAD_TOL)
    other = "up2x" if name == "down2x" else "down2x"
    # f forward; its VJP (the other pattern) in the first grad and again in
    # the second; the VJP of that VJP (this pattern again) in the second
    assert fir2x.CALLS[name] == {"forward": 1, "backward": 0, "second_order": 1}
    assert fir2x.CALLS[other] == {"forward": 0, "backward": 2, "second_order": 0}
    assert fir2x.LAUNCHES == {"down2x": 0, "up2x": 0}  # CPU tensors take the plain path


@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("case", sorted(_PATTERNS))
def test_gradcheck_and_gradgradcheck_in_f64(case, fir):
    name, _, factor, shape = _PATTERNS[case]
    fn = _FNS[name][0]
    # small planes: the checks differentiate numerically element by element
    x = torch.from_numpy(randn(7, *shape).astype(np.float64).transpose(0, 3, 1, 2).copy())
    k = _k1d(fir, factor)
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: fn(v, k), (x,))
    assert torch.autograd.gradgradcheck(lambda v: fn(v, k), (x,))


# down2x inputs of the two recipes' train steps and samplers (NCHW), and
# edge shapes: odd output widths, rows narrower than 8 and wider than a warp
_DOWN_PLAN_SHAPES = [(4, 256, 256, 256), (4, 512, 8, 8), (16, 64, 256, 256), (64, 256, 8, 8),
                     (64, 128, 32, 32), (2, 3, 38, 22), (1, 2, 70, 66), (1, 37, 4, 4),
                     (3, 5, 12, 20), (1, 3, 12, 520), (2, 1, 2, 2)]


@pytest.mark.parametrize("shape", _DOWN_PLAN_SHAPES)
def test_down2x_plan_covers_every_output_once(shape):
    """The launch plan of the down2x kernel, walked as the kernel walks it:
    lane `gid` is strip j = gid % group of row segment `unit` = gid // group;
    live lanes write outputs 4j..4j+3 of rows seg*rows .. +rows-1. Every
    output is written exactly once, groups never straddle a warp (the halo
    shuffles stay inside one), and small launches are split until they
    fill the card or a lane takes one row."""
    n, c, h, w = shape
    planes, oh, ow = n * c, h // 2, w // 2
    for aligned in (True, False):
        plan = fir2x.down2x_plan(planes, h, w, aligned)
        assert plan["vec"] == (aligned and w % 8 == 0)
    group, rows, segs = plan["group"], plan["rows"], plan["segments"]
    lanes_per_row = -(-w // 8)
    assert group >= lanes_per_row and (32 % group == 0 if group <= 32 else group % 32 == 0)
    assert 1 <= rows <= 16 and segs * rows >= oh > (segs - 1) * rows
    assert plan["lanes"] >= fir2x._TARGET_LANES or rows == 1
    gid = np.arange(plan["lanes"])
    j, unit = gid % group, gid // group
    seg, p = unit % segs, unit // segs
    live = (p < planes) & (j < lanes_per_row)
    hits = np.zeros((planes, oh, ow), np.int64)
    for i in range(rows):
        r = seg * rows + i
        for t in range(4):
            col = 4 * j + t
            ok = live & (r < oh) & (col < ow)
            np.add.at(hits, (p[ok], r[ok], col[ok]), 1)
    assert (hits == 1).all()


# up2x inputs (NCHW) of the two recipes' samplers and train steps, as G's
# up-path forward (flagship, 256²) and as down2x's VJP (DiscriminatorLarge
# at batch 4), and edge shapes: odd sides, W 2 and 4, W % 4 != 0, rows
# wider than a warp, one plane, one row
_UP_PLAN_SHAPES = [(64, 256, 4, 4), (64, 256, 8, 8), (64, 256, 16, 16), (16, 256, 8, 8),
                   (16, 256, 16, 16), (16, 128, 32, 32), (16, 128, 64, 64), (16, 64, 128, 128),
                   (4, 512, 4, 4), (4, 512, 8, 8), (4, 512, 16, 16), (4, 512, 32, 32),
                   (4, 512, 64, 64), (4, 256, 128, 128), (1, 2, 5, 7), (2, 5, 3, 3),
                   (3, 4, 6, 2), (1, 37, 4, 4), (2, 3, 10, 6), (1, 3, 7, 260), (1, 1, 9, 12),
                   (2, 3, 1, 9)]


@pytest.mark.parametrize("shape", _UP_PLAN_SHAPES)
def test_up2x_plan_covers_every_output_once(shape):
    """The launch plan of the up2x kernel, walked as the kernel walks it:
    lane `gid` is strip j = gid % group of input row segment `unit` = gid //
    group; live lanes write output columns 8j..8j+7 of rows 2m and 2m+1 for
    the input rows m = seg*rows .. +rows-1. Every output is written exactly
    once (walked over the first, second and last planes: lanes map to
    planes alike), groups never straddle a warp, and small launches are
    split until they fill the card or a lane takes one row."""
    n, c, h, w = shape
    planes, oh, ow = n * c, 2 * h, 2 * w
    for aligned in (True, False):
        plan = fir2x.up2x_plan(planes, h, w, aligned)
        assert plan["vec"] == (aligned and w % 4 == 0)
    group, rows, segs = plan["group"], plan["rows"], plan["segments"]
    lanes_per_row = -(-w // 4)
    assert group >= lanes_per_row and (32 % group == 0 if group <= 32 else group % 32 == 0)
    assert 1 <= rows <= 16 and segs * rows >= h > (segs - 1) * rows
    assert plan["lanes"] == planes * segs * group
    assert plan["lanes"] >= fir2x._TARGET_LANES or rows == 1
    walked = sorted({0, min(1, planes - 1), planes - 1})
    per_plane = segs * group
    gid = np.concatenate([np.arange(p * per_plane, (p + 1) * per_plane) for p in walked])
    j, unit = gid % group, gid // group
    seg, p = unit % segs, unit // segs
    live = (p < planes) & (j < lanes_per_row)
    slot = {q: i for i, q in enumerate(walked)}
    plane_slot = np.array([slot.get(int(q), -1) for q in p])
    idx = []
    for i in range(rows):
        m = seg * rows + i
        for dr in (0, 1):
            for t in range(8):
                col = 8 * j + t
                ok = live & (m < h) & (col < ow)
                idx.append((plane_slot[ok] * oh + 2 * m[ok] + dr) * ow + col[ok])
    hits = np.bincount(np.concatenate(idx), minlength=len(walked) * oh * ow)
    assert (hits == 1).all()

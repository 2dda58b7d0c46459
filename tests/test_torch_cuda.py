"""The CUDA kernels (fir2x, pair_conv3x3) against their plain PyTorch
versions, on the GPU.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one. They import neither JAX nor the JAX package, so on a GPU
machine without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

fir2x: shapes go beyond the flagship's (which `chip_smoke.py` checks) to
partial row strips, odd output sizes and warps that hold several planes.
Tolerances: max-abs 1e-5 in float32 (the same f32 sums in another order,
TF32 off), 2e-2 of max|ref| in bfloat16 (one rounding of the output).

pair_conv3x3: the four shapes of the 256x256 generator's gated convs at
batch 16, and shapes with a partial channel chunk and a partial column
tile; the dx route's in-kernel flip, f32 and bf16 weights and a null
bias. Both sides sum in f32 (TF32 off) and round once to bf16, so they
differ by at most one bf16 rounding step: max-abs <= 1 ulp of max|ref|.

down2x and up2x also on their scalar paths (rows that do not start on
16 bytes) and with many small planes per warp; up2x at odd sides, rows
wider than a warp and a single row, and launched from a fresh thread and
from autograd's backward thread.

Gradients: down2x / up2x to first and second order against autograd
through their plain versions (max-abs 1e-5 of max|ref| in f32), the
pair_conv3x3 VJP against autograd through its plain version (dx within 1
bf16 ulp, dW bf16-rounded on both sides, db against float64), and one
bf16 train step of a small 256x256 model whose gated convs and their dx
launch the kernel.

Both kernels also at the shapes of the 1024² generator
(`benchmark/configs/ffhq1024.json`): fir2x over 16-channel 1024² and
32-channel 512² planes, pair_conv3x3 at 512² (C_in 64) and 256² (C_in 32
and 96) at the sampler's batch of 8.

The sampler's G forward as a captured CUDA graph (`diffusion/graphed.py`):
`make_sampler` calls against `sample_from_model` on the bare net, bit for
bit, images and generator states, at small 32² and 256² recipes' shapes
and at the whole 1024² configuration (batch 2, the pyramids' step counts);
an in-place weight load after the capture; the eager paths (train mode,
grad, a profiler before the first capture); the graph's kernels in the
profiler, by name and count as an eager call's; every generator option
family captured and replayed.
"""

import numpy as np
import pytest
import torch

from ddgan_torch.nn.layers import Conv3x3
from ddgan_torch.ops import fir2x, pair_conv, resample

FIR = (1.0, 3.0, 3.0, 1.0)
FIR_ASYM = (1.0, 2.0, 3.0, 4.0)
SHAPES = [(3, 16, 8, 12), (2, 3, 38, 22), (1, 2, 70, 66), (5, 61, 8, 8), (1, 37, 4, 4)]
# the 1024² generator's largest planes (`benchmark/configs/ffhq1024.json`):
# 16 channels at 1024², 32 at 512²
FFHQ_FIR_SHAPES = [(2, 16, 1024, 1024), (2, 32, 512, 512)]


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
@pytest.mark.parametrize("shape", SHAPES + FFHQ_FIR_SHAPES)
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


# down2x shapes for the streaming kernel's paths: bf16 rows whose byte stride
# is not a multiple of 16 (W 12, 22: the scalar path), output widths 11 and
# 33, many small planes in one warp, rows wider than a warp (W 520)
DOWN_EDGE_SHAPES = [(2, 3, 10, 12), (3, 5, 22, 22), (1, 4, 14, 66), (64, 256, 4, 4),
                    (64, 256, 8, 8), (4, 64, 6, 16), (1, 3, 12, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DOWN_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_down2x_paths_match_plain(cuda_device, shape, dtype, fir, aligned):
    """down2x on the vector and the scalar path: an input that starts one
    element past a 16-byte boundary takes the scalar path whatever W is."""
    x = _randn(shape, seed=5).to(cuda_device, dtype)
    if not aligned:
        buf = torch.empty(x.numel() + 1, device=cuda_device, dtype=dtype)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    plan = fir2x.down2x_plan(shape[0] * shape[1], shape[2], shape[3], x.data_ptr() % 16 == 0)
    assert plan["vec"] == (aligned and shape[3] % 8 == 0)
    k = _taps(fir)
    with torch.no_grad():
        got, want = fir2x.down2x(x, k), fir2x.down2x_ref(x.float(), k)
    torch.cuda.synchronize()
    bound = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= bound


# up2x shapes for the streaming kernel's paths: odd sides, W 4 with many
# planes per warp, W % 4 != 0 (the scalar path), rows wider than a warp
# (W 260: halo loads at the warps' edges), a single row
UP_EDGE_SHAPES = [(1, 2, 5, 7), (2, 3, 9, 12), (64, 256, 4, 4), (3, 5, 6, 6), (1, 3, 7, 260),
                  (2, 3, 1, 16), (4, 4, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UP_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_up2x_paths_match_plain(cuda_device, shape, dtype, fir, aligned):
    """up2x on the vector and the scalar path: an input that starts one
    element past a 16-byte boundary takes the scalar path whatever W is."""
    x = _randn(shape, seed=6).to(cuda_device, dtype)
    if not aligned:
        buf = torch.empty(x.numel() + 1, device=cuda_device, dtype=dtype)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    plan = fir2x.up2x_plan(shape[0] * shape[1], shape[2], shape[3], x.data_ptr() % 16 == 0)
    assert plan["vec"] == (aligned and shape[3] % 4 == 0)
    k = _taps(fir, 2)
    before = fir2x.LAUNCHES["up2x"]
    with torch.no_grad():
        got, want = fir2x.up2x(x, k), fir2x.up2x_ref(x.float(), k)
    torch.cuda.synchronize()
    assert fir2x.LAUNCHES["up2x"] == before + 1
    bound = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= bound


@pytest.mark.cuda
def test_up2x_launches_from_a_fresh_thread_and_the_backward_thread(cuda_device):
    """up2x launched from a thread that has made no CUDA call yet, and as
    down2x's VJP on autograd's backward thread (a down2x output of odd
    sides, 3 x 5)."""
    import threading

    k = _taps(FIR_ASYM, 2)
    x = _randn((2, 3, 5, 8), seed=7).to(cuda_device)
    out = {}

    def run():
        try:
            out["y"] = fir2x.up2x(x, k)
        except Exception as exc:  # reported below, on the test's thread
            out["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    assert (out["y"] - fir2x.up2x_ref(x, k)).abs().max().item() <= 1e-5

    xd = _randn((2, 3, 6, 10), seed=8).to(cuda_device).requires_grad_(True)
    g = _randn((2, 3, 3, 5), seed=9).to(cuda_device)
    before = fir2x.LAUNCHES["up2x"]
    fir2x.down2x(xd, _taps(FIR_ASYM)).backward(g)
    torch.cuda.synchronize()
    assert fir2x.LAUNCHES["up2x"] == before + 1
    assert (xd.grad - fir2x.up2x_ref(g, _taps(FIR_ASYM)[::-1])).abs().max().item() <= 1e-5


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
    assert fir2x.LAUNCHES == before
    # an input that needs a gradient is taken: the backward is ported
    assert fir2x.up2x(x.clone().requires_grad_(), k).requires_grad


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
# the 1024² generator's gated convs at its sampler batch of 8: 64 -> 64 at
# 512², and the 256² level's first conv (C_in 32) and last concat (C_in 96)
FFHQ_PAIR_SHAPES = [(8, 64, 512, 512), (8, 32, 256, 256), (8, 96, 256, 256)]


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
@pytest.mark.parametrize("shape", PAIR_PATH_SHAPES + PAIR_EDGE_SHAPES + FFHQ_PAIR_SHAPES)
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
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (3, 64, 160, 160), (1, 64, 224, 224)])
def test_pair_conv_flip_matches_the_flipped_weights(cuda_device, shape):
    """The dx route: the kernel flips and swaps the forward weight while it
    packs it (no bias); held against the plain conv of the flipped,
    transposed weights made in PyTorch and contiguous, with a zero bias."""
    g, _, _ = _pair_inputs(shape, sum(shape) + 2, cuda_device)
    w = torch.from_numpy(np.random.RandomState(7).randn(64, 64, 3, 3).astype(np.float32)
                         / 24.0).to(cuda_device)
    before = pair_conv.LAUNCHES["pair_conv3x3"]
    with torch.no_grad():
        got = pair_conv._conv(g, w, None, flip=True)
        want = pair_conv.pair_conv3x3_ref(g, w.flip(2, 3).transpose(0, 1).contiguous(),
                                          torch.zeros(64, device=cuda_device))
    torch.cuda.synchronize()
    assert pair_conv.LAUNCHES["pair_conv3x3"] == before + 1
    scale = want.float().abs().max().item()
    assert scale > 0.5
    assert (got.float() - want.float()).abs().max().item() <= _bf16_ulp(scale)


@pytest.mark.cuda
def test_pair_conv_launches_from_a_fresh_thread(cuda_device):
    """A launch from a thread that has made no CUDA call yet, as autograd's
    backward thread can be: the kernel's tensor maps are encoded by a
    libcuda call that needs the device's context current on the thread."""
    import threading

    g, _, _ = _pair_inputs((1, 64, 128, 128), 5, cuda_device)
    w = torch.from_numpy(np.random.RandomState(8).randn(64, 64, 3, 3).astype(np.float32)
                         / 24.0).to(cuda_device)
    out = {}

    def run():
        try:
            out["y"] = pair_conv._conv(g, w, None, flip=True)
        except Exception as exc:  # reported below, on the test's thread
            out["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    want = pair_conv.pair_conv3x3_ref(g, w, None, flip=True)
    scale = want.float().abs().max().item()
    assert (out["y"].float() - want.float()).abs().max().item() <= _bf16_ulp(scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (1, 34, 160, 160), (2, 128, 128, 128)])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_pair_conv_weight_dtypes_and_null_bias(cuda_device, shape, w_dtype, with_bias):
    """The kernel reads an f32 or a bf16 weight and rounds it itself; a null
    bias is a zero bias."""
    x, wt, b = _pair_inputs(shape, sum(shape) + 3, cuda_device)
    wt = wt.to(w_dtype)
    b = b if with_bias else None
    with torch.no_grad():
        got = pair_conv.pair_conv3x3(x, wt, b)
        want = pair_conv.pair_conv3x3_ref(x, wt.float(),
                                          b if with_bias else torch.zeros(64, device=cuda_device))
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
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
    assert pair_conv.LAUNCHES["pair_conv3x3"] == before
    # an input that needs a gradient is taken: the VJP is ported
    assert pair_conv.pair_conv3x3(x, wt.clone().requires_grad_(), b).requires_grad


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


# (pattern, NCHW input) at the train step's shapes: DiscriminatorLarge at
# batch 4 and the 256² generator's up path; and odd sides: a down2x whose
# output is 3 x 5 (its VJP an odd-sided up2x), an up2x of 5 x 7
FIR_GRAD_CASES = [("down2x", (4, 256, 256, 256)), ("down2x", (4, 512, 32, 32)),
                  ("up2x", (4, 64, 128, 128)), ("down2x", (3, 5, 12, 20)),
                  ("up2x", (2, 3, 6, 4)), ("down2x", (2, 3, 6, 10)), ("up2x", (1, 2, 5, 7))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", FIR_GRAD_CASES)
@pytest.mark.parametrize("fir", [FIR, FIR_ASYM], ids=["sym", "asym"])
def test_fir_grads_match_plain_to_second_order(cuda_device, name, shape, fir):
    """grad of sum(f(a·x)²·r) in x, and the grad in the upstream scale a of
    ‖that grad‖² (R1's grad-of-grad), against autograd through the plain
    version, in float32."""
    fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                          fir2x.up2x_ref)
    k = _taps(fir, 2 if name == "up2x" else 1)
    x = _randn(shape, seed=3).to(cuda_device)
    r = _randn(tuple(fn(x, k).shape), seed=4).to(cuda_device)
    results = []
    for f in (fn, ref):
        a = torch.ones((), device=cuda_device, requires_grad=True)
        xi = a * x
        (g,) = torch.autograd.grad((f(xi, k).square() * r).sum(), xi, create_graph=True)
        (ga,) = torch.autograd.grad(g.square().sum(), a)
        results.append((g.detach(), ga.detach()))
    torch.cuda.synchronize()
    (g, ga), (g_ref, ga_ref) = results
    assert (g - g_ref).abs().max().item() <= 1e-5 * g_ref.abs().max().item()
    assert abs(ga.item() - ga_ref.item()) <= 1e-5 * abs(ga_ref.item())


@pytest.mark.cuda
def test_fir_backward_launches_the_kernels(cuda_device):
    x = _randn((2, 8, 16, 16)).to(cuda_device).requires_grad_(True)
    fir2x.reset_launch_counts()
    (g,) = torch.autograd.grad(fir2x.down2x(x, _taps(FIR)).square().sum(), x,
                               create_graph=True)
    g.square().sum().backward()
    assert fir2x.LAUNCHES == {"down2x": 2, "up2x": 2}
    assert fir2x.CALLS["down2x"] == {"forward": 1, "backward": 0, "second_order": 1}
    assert fir2x.CALLS["up2x"] == {"forward": 0, "backward": 2, "second_order": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAIR_PATH_SHAPES[:1] + [(4, 128, 256, 256), (4, 64, 128, 128),
                                                          (4, 128, 128, 128)])
def test_pair_conv_vjp_matches_plain(cuda_device, shape):
    x, wt, b = _pair_inputs(shape, sum(shape) + 1, cuda_device)
    g = torch.from_numpy(np.random.RandomState(9).randn(shape[0], 64, shape[2], shape[3])
                         .astype(np.float32)).to(cuda_device, torch.bfloat16)
    grads = []
    pair_conv.reset_launch_counts()
    for f in (pair_conv.pair_conv3x3, pair_conv.pair_conv3x3_ref):
        xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, wt, b))
        f(xi, wi, bi).backward(g)
        grads.append((xi.grad, wi.grad, bi.grad))
    torch.cuda.synchronize()
    gated = shape[1] == 64
    assert pair_conv.CALLS == {"forward": 1, "dx": int(gated), "dx_library": int(not gated)}
    assert pair_conv.LAUNCHES["pair_conv3x3"] == 1 + gated
    (dx, dw, db), (dx_r, dw_r, db_r) = grads
    scale = dx_r.float().abs().max().item()
    assert dx.dtype == torch.bfloat16 and (dx.float() - dx_r.float()).abs().max().item() <= \
        _bf16_ulp(scale)
    # the plain dW is f32; the port's is the library's bf16 result, cast
    assert (dw - dw_r.to(torch.bfloat16).float()).abs().max().item() <= \
        2 * _bf16_ulp(dw_r.abs().max().item())
    db_true = g.double().sum((0, 2, 3))
    assert (db.double() - db_true).abs().max().item() <= 1e-4 * db_true.abs().max().item()
    assert (db_r.double() - db_true).abs().max().item() <= 1e-4 * db_true.abs().max().item()


@pytest.mark.cuda
def test_bf16_train_step_at_256_launches_the_kernels(cuda_device):
    """One bf16 train step (R1 on) of a narrow 256² model: NCSN++ nf 64,
    ch_mult [1, 1, 2], 1 resblock, DiscriminatorLarge ngf 4, batch 2."""
    from ddgan_torch.config import Config
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.train import ClippedAdam, create_train_state, make_train_step

    cfg = Config(image_size=256, num_channels=3, num_channels_dae=64, ch_mult=[1, 1, 2],
                 num_res_blocks=1, attn_resolutions=[], nz=8, z_emb_dim=16, n_mlp=1,
                 t_emb_dim=16, ngf=4, num_timesteps=2, dropout=0.0, disc_small="no",
                 compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    gen = NCSNpp.from_config(cfg, generator=g).to(cuda_device)
    disc = build_discriminator(cfg, generator=g).to(cuda_device)
    state = create_train_state(gen, disc, ClippedAdam(gen.parameters(), 0.5, 0.9),
                               ClippedAdam(disc.parameters(), 0.5, 0.9))
    step = make_train_step(
        DiffusionCoefficients.create(2, 0.1, 20.0, device=cuda_device),
        PosteriorCoefficients.create(2, 0.1, 20.0, device=cuda_device),
        num_timesteps=2, nz=cfg.nz, r1_gamma=2.0, lazy_reg=10, ema_decay=0.999, use_ema=True)
    real = torch.rand((2, 3, 256, 256), device=cuda_device) * 2 - 1
    fir2x.reset_launch_counts()
    pair_conv.reset_launch_counts()
    m = step(state, real, torch.Generator(device=cuda_device).manual_seed(1), 1e-4, 1e-4)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in m) and float(m.grad_penalty) > 0
    assert all(bool(torch.isfinite(p).all()) for p in gen.parameters())
    # the 256² and 128² levels' Conv_0/Conv_1 (C_in 64) in both G forwards,
    # and their dx in G's backward
    assert pair_conv.CALLS["forward"] > 0 and pair_conv.CALLS["dx"] > 0
    assert pair_conv.LAUNCHES["pair_conv3x3"] == pair_conv.CALLS["forward"] + pair_conv.CALLS["dx"]
    assert fir2x.CALLS["down2x"]["second_order"] == 12  # six D blocks, two down2x each
    assert sum(fir2x.LAUNCHES.values()) == sum(sum(c.values()) for c in fir2x.CALLS.values())


# --------------------------------------------------------------------------
# the sampler's G forward as a captured CUDA graph (`diffusion/graphed.py`)
def _sampler_net(case: str, device):
    """An NCSN++ shaped like a recipe, with non-trivial weights, in eval
    mode: small "cifar" (32², the residual input pyramid of FIR convs,
    attention, T=4) or "celeba" (256², nf 64, the skip pyramids: K2's gated
    convs and K1 at 256², T=2), or "ffhq1024", the benchmark's 1024²
    configuration whole at batch 2 (eight levels, both skip pyramids)."""
    import json
    from pathlib import Path

    from ddgan_torch.config import Config
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.utils import randomize_parameters_

    if case == "ffhq1024":
        path = Path(__file__).resolve().parent.parent / "benchmark" / "configs" / "ffhq1024.json"
        cfg = Config.from_dict(json.loads(path.read_text())["config"])
        net = randomize_parameters_(NCSNpp.from_config(cfg), 3).to(device).eval()
        return cfg, net, 2

    common = dict(num_channels=3, num_res_blocks=1, nz=16, z_emb_dim=32, n_mlp=2,
                  t_emb_dim=32, compute_dtype="bfloat16")
    if case == "cifar":
        cfg = Config(image_size=32, num_channels_dae=32, ch_mult=[1, 2, 2],
                     attn_resolutions=[16], num_timesteps=4, dropout=0.1, **common)
        batch = 8
    else:
        cfg = Config(image_size=256, num_channels_dae=64, ch_mult=[1, 1, 2], attn_resolutions=[],
                     num_timesteps=2, dropout=0.0, progressive="output_skip",
                     progressive_input="input_skip", progressive_combine="sum", **common)
        batch = 2
    net = randomize_parameters_(NCSNpp.from_config(cfg), 3).to(device).eval()
    return cfg, net, batch


def _eager_call(cfg, net, batch, device, rng):
    """What `make_sampler`'s call computes, with the bare net as G."""
    from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model

    pos = PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                       cfg.use_geometric, device=device)
    shape = (batch, cfg.num_channels, cfg.image_size, cfg.image_size)
    x_init = torch.randn(shape, generator=rng, device=device)
    return sample_from_model(pos, net, cfg.num_timesteps, x_init, cfg.nz, rng)


def _tallies():
    from ddgan_torch.models import ncsnpp

    return (dict(fir2x.LAUNCHES), {k: dict(v) for k, v in fir2x.CALLS.items()},
            dict(pair_conv.LAUNCHES), dict(pair_conv.CALLS), dict(ncsnpp.SKIP_STEPS))


def _tally_delta(before, after):
    def sub(a, b):
        return {k: sub(a[k], b[k]) if isinstance(a[k], dict) else a[k] - b[k] for k in a}
    return tuple(sub(a, b) for a, b in zip(after, before))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cifar", "celeba", "ffhq1024"])
def test_graphed_sampler_equals_eager_bit_for_bit(cuda_device, case):
    """Three `make_sampler` calls (one capture, then replays only) against
    `sample_from_model` on the bare net from the same generator state:
    images and generator states equal bit for bit, and the hand kernels'
    and the pyramids' tallies advance by what an eager call's do."""
    from ddgan_torch.cli import test_cli
    from ddgan_torch.diffusion import graphed

    cfg, net, batch = _sampler_net(case, cuda_device)
    rng = torch.Generator(device=cuda_device).manual_seed(11)
    sample = test_cli.make_sampler(cfg, net, batch, cuda_device, rng)
    graphed.reset_counts()
    for call in range(3):
        ref_rng = _gen_at(cuda_device, rng.get_state())
        before = _tallies()
        got = sample().clone()
        torch.cuda.synchronize()
        mid = _tallies()
        want = _eager_call(cfg, net, batch, cuda_device, ref_rng)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(want).all()) and float(want.std()) > 0.05
        assert torch.equal(got, want), f"call {call}: max-abs {(got - want).abs().max().item()}"
        assert torch.equal(rng.get_state(), ref_rng.get_state())
        assert _tally_delta(before, mid) == _tally_delta(mid, _tallies())
    steps = 3 * cfg.num_timesteps
    assert graphed.CALLS == {"capture": 1, "replay": steps - 1, "eager": 0}
    assert sum(fir2x.LAUNCHES.values()) > 0
    if case != "cifar":
        assert _tally_delta(before, mid)[2]["pair_conv3x3"] > 0
    if case == "ffhq1024":  # eight levels, seven transitions a forward
        assert _tally_delta(before, mid)[4] == {"skip_out": 8 * cfg.num_timesteps,
                                                "skip_in": 7 * cfg.num_timesteps}


@pytest.mark.cuda
def test_graphed_sampler_reads_the_weights_in_place(cuda_device):
    """A `load_state_dict` into the captured net's own tensors after the
    capture shows, bit for bit, in the next call's images."""
    from ddgan_torch.cli import test_cli
    from ddgan_torch.diffusion import graphed
    from ddgan_torch.utils import randomize_parameters_

    cfg, net, batch = _sampler_net("celeba", cuda_device)
    rng = torch.Generator(device=cuda_device).manual_seed(5)
    sample = test_cli.make_sampler(cfg, net, batch, cuda_device, rng)
    sample()
    sample()
    state = rng.get_state()
    old = sample().clone()
    with torch.no_grad():
        net.load_state_dict(randomize_parameters_(net.__class__.from_config(cfg), 9).state_dict())
    graphed.reset_counts()
    rng.set_state(state)
    got = sample().clone()
    want = _eager_call(cfg, net, batch, cuda_device, _gen_at(cuda_device, state))
    torch.cuda.synchronize()
    assert graphed.CALLS == {"capture": 0, "replay": cfg.num_timesteps, "eager": 0}
    assert not torch.equal(got, old)
    assert torch.equal(got, want)


def _gen_at(device, state):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["train_mode", "grad", "profiler"])
def test_graphed_forward_stays_eager(cuda_device, why):
    """A net in train mode, grad enabled, and a profiler recording before
    the first capture take the eager path and capture nothing; once the
    profiler has stopped, a call captures, and under the profiler again the
    graph is replayed."""
    from ddgan_torch.diffusion import graphed

    cfg, net, batch = _sampler_net("cifar", cuda_device)
    g = graphed.GraphedForward(net)
    x = torch.randn((batch, 3, cfg.image_size, cfg.image_size), device=cuda_device)
    t = torch.full((batch,), 2, dtype=torch.int64, device=cuda_device)
    z = torch.randn((batch, cfg.nz), device=cuda_device)
    with torch.no_grad():
        want = net(x, t, z)
    graphed.reset_counts()
    if why == "train_mode":
        net.train()
        with torch.no_grad():
            got = [g(x, t, z) for _ in range(2)]
        net.eval()
    elif why == "grad":
        got = [g(x, t, z).detach() for _ in range(2)]
    else:
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            got = [g(x, t, z).clone() for _ in range(2)]
    torch.cuda.synchronize()
    assert graphed.CALLS == {"capture": 0, "replay": 0, "eager": 2} and not g.graphs
    if why != "train_mode":  # dropout 0.1 draws in train mode
        assert all(torch.equal(o, want) for o in got)
    if why == "profiler":
        with torch.no_grad():
            first = g(x, t, z).clone()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                again = g(x, t, z).clone()
        torch.cuda.synchronize()
        assert graphed.CALLS == {"capture": 1, "replay": 1, "eager": 2}
        assert torch.equal(first, want) and torch.equal(again, want)


def _device_kernels(prof) -> dict:
    """Kernels (not copies or fills) of a profiled slice, by name."""
    from collections import Counter

    return Counter(e.name for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("Memcpy", "Memset")))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cifar", "celeba"])
def test_graphed_sampler_kernels_appear_in_the_profiler(cuda_device, case):
    """A replayed call under the profiler shows the graph's kernels: the
    same kernels, by name and count, as an eager call of the bare net, the
    fir2x ones as many as `fir2x.LAUNCHES` advanced by, and a handful of
    host launches in place of thousands."""
    from torch.profiler import ProfilerActivity, profile

    from ddgan_torch.cli import test_cli
    from ddgan_torch.diffusion import graphed

    cfg, net, batch = _sampler_net(case, cuda_device)
    rng = torch.Generator(device=cuda_device).manual_seed(2)
    sample = test_cli.make_sampler(cfg, net, batch, cuda_device, rng)
    sample()
    torch.cuda.synchronize()
    launches = {}
    kernels = {}
    for side in ("eager", "graph"):
        graphed.reset_counts()
        before = sum(fir2x.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if side == "graph":
                sample()
            else:
                _eager_call(cfg, net, batch, cuda_device, torch.Generator(device=cuda_device))
            torch.cuda.synchronize()
        kernels[side] = _device_kernels(prof)
        launches[side] = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                        "cuLaunchKernelEx", "cudaGraphLaunch")
                             for e in prof.events())
        fir = sum(n for name, n in kernels[side].items()
                  if "down2x_kernel" in name or "up2x_kernel" in name)
        assert fir == sum(fir2x.LAUNCHES.values()) - before > 0
    assert graphed.CALLS == {"capture": 0, "replay": cfg.num_timesteps, "eager": 0}
    assert kernels["graph"] == kernels["eager"]
    assert launches["graph"] < 30 * cfg.num_timesteps < launches["eager"]


@pytest.mark.cuda
def test_graphed_forward_captures_every_generator_family(cuda_device):
    """Each NCSN++ option family of `chip_smoke.FAMILIES` (FIR convs up and
    down, both pyramids, DDPM blocks, naive resampling, Fourier embedding,
    unconditional), tiny and in bf16: a capture, then two replays on new
    inputs, each equal bit for bit to the bare net."""
    import importlib.util
    from pathlib import Path

    from ddgan_torch.config import Config
    from ddgan_torch.diffusion import graphed
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.utils import randomize_parameters_

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, family in sorted(smoke.FAMILIES.items()):
        kw = dict(image_size=16, num_channels=3, num_channels_dae=16, ch_mult=[1, 2],
                  num_res_blocks=1, attn_resolutions=[8], nz=8, z_emb_dim=16, n_mlp=1,
                  t_emb_dim=16, dropout=0.1, compute_dtype="bfloat16")
        cfg = Config(**{**kw, **family})
        net = randomize_parameters_(NCSNpp.from_config(cfg), 4).to(cuda_device).eval()
        g = graphed.GraphedForward(net)
        graphed.reset_counts()
        for i in range(3):
            gen = torch.Generator(device=cuda_device).manual_seed(i)
            x = torch.randn((2, 3, 16, 16), generator=gen, device=cuda_device)
            t = torch.tensor([1, 3], device=cuda_device)  # t >= 1: Fourier takes log(t)
            z = torch.randn((2, cfg.nz), generator=gen, device=cuda_device)
            with torch.no_grad():
                got = g(x, t, z).clone()
                want = net(x, t, z)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(want).all()), name
            assert torch.equal(got, want), f"{name}, call {i}"
        assert graphed.CALLS == {"capture": 1, "replay": 2, "eager": 0}, name

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ddgan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It drives the port's two sampler paths with random
seeded weights and fails (non-zero exit) if any phase fails.

The flagship CIFAR-10 T=4 sampler (NCSN++ nf 128, ch_mult 1 2 2 2, batch 64):

  1. print the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from ddgan_torch/csrc/ (sm_90a), one nvcc
     each, started together: fir2x.cu and pair_conv3x3.cu;
  3. hold down2x / up2x against their plain PyTorch versions at every
     flagship shape, f32 and bf16, symmetric and asymmetric taps;
  4. build the generator with non-trivial weights (output std > 0.05);
  5. run the T=4 sampler at batch 64 in f32 (TF32 off for matmuls and
     cuDNN) and compare with the port's plain path on the CPU, on the same
     weights, x_init, z's and noises (max-abs <= 2e-3);
  6. check the launch counts: 6 down2x and 6 up2x per generator forward,
     24 of each per sampler call, and no pair_conv3x3 (no flagship conv
     passes its gate);
  7. the main path: the sampler CLI (`ddgan_torch.cli.test_cli`) on a temp
     experiment with a content_args.json and netG_1.pth written here, with
     the launch counts reset before it and read after; then its FID-set
     loop `generate_samples`; the PNGs must appear;
  8. time the sampler (bf16 as the recipe sets it, and f32) and each FIR
     kernel beside its plain version, the one PyTorch call that computes
     the same function, and its bound;
  9. profile two bf16 sampler calls: device time by kernel class and the
     share of a call's time that the device spends in kernels.

The CelebA-HQ 256 T=2 sampler (nf 64, ch_mult 1 1 2 2 4 4, 2 resblocks,
attention at 16, n_mlp 3; batch 16):

 10. hold pair_conv3x3 against its plain version at the four shapes of the
     generator's gated convs at batch 16 and at batch 2 (max-abs <= 1 bf16
     ulp of max|ref|), and check that gated-out shapes and dtypes raise;
 11. hold down2x / up2x against their plain versions at the 256² shapes;
 12. build the full-width generator with weights N(0,1)/sqrt(fan_in): its
     parameter count and output std (> 0.05);
 13. run the T=2 sampler in f32, TF32 off, against the CPU plain path at
     batch 2 (max-abs <= 2e-3; pair_conv3x3 is gated off in f32);
 14. run it in bf16 at batch 16: 46 pair_conv3x3, 20 down2x and 20 up2x
     launches, and the output within 0.03 max-abs of the f32 GPU run (the
     bound of tests/test_torch_ncsnpp.py::test_bf16_close_to_f32);
 15. the main path: the sampler CLI on a temp CelebA-HQ 256 experiment,
     launch counts reset before it and read after; 256² PNGs must appear;
 16. time the sampler (samples/s, bf16 and f32) and pair_conv3x3 per shape
     beside its bound, its plain version and the library call
     (`F.conv2d` in bf16, timed only), and the FIR kernels at 256²;
 17. profile two bf16 calls, with pair_conv3x3 as its own kernel class;
 18. print the result, a `{"kernels": [...]}` line, and the `{"ok": true, ...}`
     line last.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH = 64
T = 4
BATCH_256 = 16
T_256 = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
FIR = (1.0, 3.0, 3.0, 1.0)
FIR_ASYM = (1.0, 2.0, 3.0, 4.0)
# flagship FIR inputs (B, C, H, W): the down blocks at 32/16/8, the up blocks at 4/8/16
DOWN_SHAPES = [(BATCH, 128, 32, 32), (BATCH, 256, 16, 16), (BATCH, 256, 8, 8)]
UP_SHAPES = [(BATCH, 256, 4, 4), (BATCH, 256, 8, 8), (BATCH, 256, 16, 16)]
# CelebA-HQ 256 FIR inputs: the down blocks at 256..16, the up blocks at 8..128
DOWN_SHAPES_256 = [(BATCH_256, 64, 256, 256), (BATCH_256, 64, 128, 128),
                   (BATCH_256, 128, 64, 64), (BATCH_256, 128, 32, 32), (BATCH_256, 256, 16, 16)]
UP_SHAPES_256 = [(BATCH_256, 256, 8, 8), (BATCH_256, 256, 16, 16), (BATCH_256, 128, 32, 32),
                 (BATCH_256, 128, 64, 64), (BATCH_256, 64, 128, 128)]
# CelebA-HQ 256 gated convs: (C_in, side) -> convs per generator forward
PAIR_CONVS = {(64, 256): 9, (128, 256): 3, (64, 128): 9, (128, 128): 2}
REPLACES = {
    "down2x": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:133",
    "up2x": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:158",
    "pair_conv3x3": "ddgan_tpu/ops/experimental/pallas_conv.py:189",
}
SOURCES = {
    "down2x": "ddgan_torch/csrc/fir2x.cu",
    "up2x": "ddgan_torch/csrc/fir2x.cu",
    "pair_conv3x3": "ddgan_torch/csrc/pair_conv3x3.cu",
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def flagship_config(Config):
    """The CIFAR-10 recipe of `__graft_entry__._flagship_config` (weights random)."""
    return Config(
        dataset="cifar10", image_size=32, num_channels=3,
        num_channels_dae=128, ch_mult=[1, 2, 2, 2], num_res_blocks=2,
        attn_resolutions=[16], nz=100, z_emb_dim=256, n_mlp=4,
        t_emb_dim=256, ngf=64, num_timesteps=T, batch_size=BATCH,
        dropout=0.1, compute_dtype="bfloat16",
    )


def celeba256_config(Config):
    """The CelebA-HQ 256 paper recipe of `tools/bench_extra.py:105-113`
    (readme.md:50-57 of the reference), weights random."""
    return Config(
        dataset="celeba_256", image_size=256, num_channels=3,
        num_channels_dae=64, ch_mult=[1, 1, 2, 2, 4, 4], num_res_blocks=2,
        attn_resolutions=[16], nz=100, z_emb_dim=256, n_mlp=3,
        t_emb_dim=256, ngf=64, num_timesteps=T_256, batch_size=BATCH_256,
        r1_gamma=2.0, lazy_reg=10, ema_decay=0.999, dropout=0.0,
        disc_small="no", compute_dtype="bfloat16",
    )


def taps(kind: str, fir) -> tuple:
    """The separable taps the resample layer hands the kernel (gain 1)."""
    k = np.asarray(fir, np.float64)
    return tuple((k / k.sum() * (2 if kind == "up2x" else 1)).tolist())


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def device_ms(fn, inputs, iters: int) -> float:
    """Device time of one call of `fn`, from CUDA events around `iters`
    calls cycling over `inputs`. A sleep kernel queued first keeps the GPU
    busy while the host enqueues, so host overhead does not show."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(4 * host_s * 2e9 + 2e6, 2e10)))
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotation(shape, dtype, out_elems: int, seed: int):
    """Copies of one input, enough that inputs and outputs of a cycle
    (> 128 MB) do not stay in the 50 MB L2 cache."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    per = (x.numel() + out_elems) * x.element_size()
    n = max(2, math.ceil(128e6 / per))
    return [x.clone() for _ in range(n)]


def fir_bound_ms(kind: str, shape, dtype) -> tuple[float, str]:
    n, c, h, w = shape
    planes, item = n * c, torch.empty((), dtype=dtype).element_size()
    if kind == "down2x":
        out = h * w // 4
        flops = planes * (h * (w // 2) * 8 + out * 8)  # 4 taps a pass
    else:
        out = 4 * h * w
        flops = planes * (h * 2 * w * 4 + out * 4)  # 2 taps a pass
    t_bytes = planes * (h * w + out) * item / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pair_bound_ms(shape) -> tuple[float, str]:
    """x and w (bf16) and b (f32) read once, y (bf16) written once, at the
    HBM rate; 2*64*9*C_in flops per output pixel at the bf16 peak."""
    n, c, h, w = shape
    t_bytes = (n * c * h * w * 2 + 64 * c * 9 * 2 + 64 * 4 + n * 64 * h * w * 2) / HBM_BYTES_PER_S
    t_ops = 2 * n * h * w * 64 * 9 * c / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_call(kind: str, k1d):
    """The one PyTorch call that computes the same function (timed only)."""
    k = torch.tensor(np.outer(k1d, k1d), dtype=torch.float32, device="cuda")

    def call(x):
        c = x.shape[1]
        if kind == "down2x":  # correlation with the flipped kernel, pad 1, stride 2
            w = torch.flip(k, (0, 1)).to(x.dtype).expand(c, 1, 4, 4)
            return F.conv2d(x, w, stride=2, padding=1, groups=c)
        # transposed conv applies the flipped kernel to the dilated input
        w = k.to(x.dtype).expand(c, 1, 4, 4)
        return F.conv_transpose2d(x, w, stride=2, padding=1, groups=c)

    return call


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "fir2x" in low:
        return "fir2x"
    if "pair_conv3x3" in low:
        return "pair_conv3x3"
    if any(s in low for s in ("conv", "cudnn", "xmma", "implicit", "winograd", "fft")):
        return "convolution"
    if any(s in low for s in ("gemm", "cutlass", "cublas", "sm90_")):
        return "matmul"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduction/norm/softmax"
    return "elementwise/copy/other"


def profile_sampler(call, call_ms: float, calls: int = 2) -> dict:
    """Device time by kernel class over `calls` sampler calls, and the share
    of a call's time (`call_ms`, timed without the profiler, whose host
    overhead stretches the window it records) that the device spends in
    kernels (they run on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        # kernel entries only: an operator's entry repeats its kernels' time
        us = float(getattr(ev, "self_device_time_total", 0.0))
        if us > 0 and str(ev.device_type).endswith("CUDA"):
            cls = _kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + us
            kernels.append((us, ev.count, ev.key))
    busy_us = sum(by_class.values())
    kernels.sort(reverse=True)
    for us, count, key in kernels[:12]:
        print(f"{us / calls / 1e3:9.3f} ms/call {count // calls:6d} launches/call  {key[:90]}")
    out = {
        "calls": calls,
        "call_ms": call_ms,
        "profiled_wall_ms_per_call": wall_us / calls / 1e3,
        "device_busy_ms_per_call": busy_us / calls / 1e3,
        "device_busy_share": busy_us / calls / 1e3 / call_ms if busy_us else None,
        "kernel_launches_per_call": sum(c for _, c, _ in kernels) // calls,
        "ms_per_call_by_class": {k: v / calls / 1e3 for k, v in sorted(by_class.items())},
    }
    if not busy_us:
        print("profiler recorded no device time: device breakdown not measured")
    print(json.dumps({"profile": out}))
    return out


def sampler_ms(call, warmup: int, iters: int) -> float:
    """Mean time of one sampler call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_fir_kernels(fir2x, shapes_by_kind, max_abs: dict) -> None:
    """Each FIR kernel against its plain version at `shapes_by_kind`, f32
    (max-abs 1e-5) and bf16 (2e-2 of max|ref|), both tap sets."""
    for name, shapes in shapes_by_kind.items():
        fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                              fir2x.up2x_ref)
        for i_shape, shape in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                for fir in (FIR, FIR_ASYM):
                    g = torch.Generator(device="cuda").manual_seed(i_shape)
                    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
                    k = taps(name, fir)
                    with torch.no_grad():
                        got, want = fn(x, k), ref(x, k)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    if dtype == torch.float32:
                        max_abs[name] = max(max_abs[name], err)
                        check(err <= 1e-5, f"{name} {shape} f32 {fir}: max-abs {err}")
                    else:
                        check(err <= 2e-2 * scale, f"{name} {shape} bf16 {fir}: {err} vs {scale}")
                    print(f"{name} {shape} {str(dtype)[6:]} taps {fir}: max-abs {err:.3g} "
                          f"(max|ref| {scale:.3g})")


def time_fir_kernels(fir2x, shapes_by_kind, model: str) -> dict:
    """Per-shape rows (kernel, plain, library, bound) for each FIR kernel."""
    rows_by_kind = {}
    for name, shapes in shapes_by_kind.items():
        fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                              fir2x.up2x_ref)
        k = taps(name, FIR)
        lib = library_call(name, k)
        rows = []
        for shp in shapes:
            # in a bf16 forward the h path runs bf16 and the skip path f32
            for dtype in (torch.bfloat16, torch.float32):
                n_in = math.prod(shp)
                bufs = rotation(shp, dtype, n_in * 4 if name == "up2x" else n_in // 4, seed=3)
                iters = max(50, 2 * len(bufs))
                with torch.no_grad():
                    k_ms = device_ms(lambda x: fn(x, k), bufs, iters)
                    p_ms = device_ms(lambda x: ref(x, k), bufs, iters)
                    l_ms = device_ms(lib, bufs, iters)
                    want = ref(bufs[0], k).float()
                    same = (lib(bufs[0]).float() - want).abs().max().item()
                tol = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
                check(same <= tol, f"library call for {name} computes another function ({same})")
                b_ms, b_by = fir_bound_ms(name, shp, dtype)
                rows.append({"model": model, "shape": list(shp), "dtype": str(dtype)[6:],
                             "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                             "bound_by": b_by})
                print(f"{name} {shp} {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f}, "
                      f"library {l_ms:.4f}, bound {b_ms:.4f} ({b_by})")
                del bufs
        rows_by_kind[name] = rows
    return rows_by_kind


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "ddgan_torch" / "csrc" / "pair_conv3x3.cu").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ddgan_torch.cli import test_cli
    from ddgan_torch.config import Config
    from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model_with_noise
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.ops import fir2x, pair_conv
    from ddgan_torch.utils import randomize_parameters_

    def reset_counts() -> None:
        fir2x.reset_launch_counts()
        pair_conv.reset_launch_counts()

    def counts() -> dict:
        return {**fir2x.LAUNCHES, **pair_conv.LAUNCHES}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("1 card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase("2 build (one nvcc per source, started together)")

    def timed_build(mod):
        t0 = time.perf_counter()
        mod.build(verbose=True)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {name: pool.submit(timed_build, mod)
                for name, mod in (("fir2x", fir2x), ("pair_conv3x3", pair_conv))}
        build_s = {name: f.result() for name, f in futs.items()}
    print(f"built {build_s} (s); all in {time.perf_counter() - t0:.1f} s")

    phase("3 FIR kernels against their plain versions, flagship shapes")
    max_abs = {"down2x": 0.0, "up2x": 0.0, "pair_conv3x3": 0.0}
    check_fir_kernels(fir2x, {"down2x": DOWN_SHAPES, "up2x": UP_SHAPES}, max_abs)

    phase("4 flagship generator")
    cfg = flagship_config(Config)
    cfg32 = cfg.replace(compute_dtype="float32")
    net_cpu = randomize_parameters_(NCSNpp.from_config(cfg32), seed=0).eval()
    net32 = copy.deepcopy(net_cpu).to(dev).eval()
    net16 = NCSNpp.from_config(cfg)
    net16.load_state_dict(net_cpu.state_dict())
    net16 = net16.to(dev).eval()
    n_params = sum(p.numel() for p in net_cpu.parameters())
    rs = np.random.RandomState(0)
    shape = (BATCH, cfg.num_channels, cfg.image_size, cfg.image_size)
    x_init = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    zs = [torch.from_numpy(rs.randn(BATCH, cfg.nz).astype(np.float32)) for _ in range(T)]
    noises = [torch.from_numpy(rs.randn(*shape).astype(np.float32)) for _ in range(T)]
    t_last = torch.full((BATCH,), T - 1, dtype=torch.int64)
    reset_counts()
    with torch.no_grad():
        out = net32(x_init.to(dev), t_last.to(dev), zs[0].to(dev))
    torch.cuda.synchronize()
    fwd_launches = counts()
    std = out.std().item()
    print(f"NCSNpp {n_params} parameters; forward {tuple(out.shape)} std {std:.4f}; "
          f"launches {fwd_launches}")
    check(out.shape == shape and bool(torch.isfinite(out).all()), "bad generator output")
    check(std > 0.05, f"generator output std {std}: weights are trivial")

    phase("5 T=4 sampler, GPU f32 (TF32 off) against the CPU plain path")
    coeff_gpu = PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device=dev)
    coeff_cpu = PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device="cpu")
    reset_counts()
    got = sample_from_model_with_noise(
        coeff_gpu, net32, T, x_init.to(dev), [z.to(dev) for z in zs], [n.to(dev) for n in noises])
    torch.cuda.synchronize()
    sampler_launches = counts()
    t0 = time.perf_counter()
    want = sample_from_model_with_noise(coeff_cpu, net_cpu, T, x_init, zs, noises)
    cpu_s = time.perf_counter() - t0
    sampler_err = (got.cpu() - want).abs().max().item()
    print(f"sampler GPU vs CPU max-abs {sampler_err:.3g} (CPU took {cpu_s:.1f} s); "
          f"sample std {want.std().item():.4f}; launches {sampler_launches}")
    check(bool(torch.isfinite(got).all()) and got.shape == shape, "bad sampler output")
    check(sampler_err <= 2e-3, f"sampler GPU vs CPU max-abs {sampler_err} > 2e-3")

    phase("6 launch counts")
    check(fwd_launches == {"down2x": 6, "up2x": 6, "pair_conv3x3": 0},
          f"per forward: {fwd_launches}")
    check(sampler_launches == {"down2x": 24, "up2x": 24, "pair_conv3x3": 0},
          f"per sampler call: {sampler_launches}")

    phase("7 main path: the sampler CLI and its FID-set loop")
    with tempfile.TemporaryDirectory() as tmp:
        exp = Path(tmp) / "saved_info" / "dd_gan" / "cifar10" / "smoke"
        exp.mkdir(parents=True)
        (exp / "content_args.json").write_text(json.dumps(cfg.replace(exp="smoke").to_dict()))
        torch.save(net_cpu.state_dict(), exp / "netG_1.pth")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            test_cli.main(["--dataset", "cifar10", "--exp", "smoke", "--epoch_id", "1",
                           "--seed", "0"])
            torch.cuda.synchronize()
            main_launches = counts()
            pngs = sorted((Path(tmp) / "generated_samples" / "cifar10").glob("sample_*.png"))
            check(len(pngs) == BATCH, f"CLI wrote {len(pngs)} PNGs, expected {BATCH}")
            head = pngs[0].read_bytes()[:24]
            check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == (32).to_bytes(4, "big") * 2,
                  "CLI PNG is not a 32x32 PNG")
            check(main_launches == {"down2x": 24, "up2x": 24, "pair_conv3x3": 0},
                  f"CLI run: {main_launches}")

            args = test_cli.build_parser().parse_args(["--dataset", "cifar10", "--exp", "smoke"])
            loaded = test_cli.load_config(exp, args)
            gen = test_cli.load_generator(exp, loaded, 1, dev)
            sample = test_cli.make_sampler(loaded, gen, BATCH, dev,
                                           torch.Generator(device=dev).manual_seed(1))
            reset_counts()
            n = test_cli.generate_samples(sample, 100, BATCH, Path(tmp) / "fid_set", tag="smoke")
            loop_launches = counts()
            n_png = len(list((Path(tmp) / "fid_set").glob("*.png")))
            check(n == 100 and n_png == 100, f"FID-set loop wrote {n_png} PNGs, expected 100")
            check(loop_launches == {"down2x": 48, "up2x": 48, "pair_conv3x3": 0},
                  f"FID-set loop: {loop_launches}")
        finally:
            os.chdir(cwd)
    print(f"CLI: {len(pngs)} PNGs, launches {main_launches}; FID-set loop: {n_png} PNGs, "
          f"launches {loop_launches}")

    phase("8 flagship timing")
    results = {}
    for label, net in (("bf16", net16), ("f32", net32)):
        call = test_cli.make_sampler(cfg, net, BATCH, dev, torch.Generator(device=dev).manual_seed(2))
        results[label] = sampler_ms(call, warmup=3, iters=10)
        print(f"sampler {label}: {results[label]:.3f} ms per T=4 call at batch {BATCH} = "
              f"{BATCH / results[label] * 1e3:.1f} samples/s")
    fir_rows = time_fir_kernels(fir2x, {"down2x": DOWN_SHAPES, "up2x": UP_SHAPES}, "flagship")

    phase("9 where the flagship sampler's time goes (torch.profiler, bf16)")
    profile = profile_sampler(test_cli.make_sampler(
        cfg, net16, BATCH, dev, torch.Generator(device=dev).manual_seed(4)), results["bf16"])
    del net16, net32, net_cpu, got, want, out

    phase("10 pair_conv3x3 against its plain version")
    pair_shapes = [(BATCH_256, c, s, s) for (c, s) in PAIR_CONVS] + [(2, 64, 128, 128)]
    for i, shp in enumerate(pair_shapes):
        n, c, h, w = shp
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
        wt = torch.randn((64, c, 3, 3), generator=g, device=dev) / math.sqrt(9 * c)
        b = torch.randn((64,), generator=g, device=dev)
        with torch.no_grad():
            got_k, want_k = pair_conv.pair_conv3x3(x, wt, b), pair_conv.pair_conv3x3_ref(x, wt, b)
        torch.cuda.synchronize()
        err = (got_k.float() - want_k.float()).abs().max().item()
        scale = want_k.float().abs().max().item()
        max_abs["pair_conv3x3"] = max(max_abs["pair_conv3x3"], err)
        check(got_k.dtype == torch.bfloat16 and got_k.shape == (n, 64, h, w), f"{shp}: bad output")
        check(err <= bf16_ulp(scale), f"pair_conv3x3 {shp}: max-abs {err} > 1 ulp of {scale}")
        print(f"pair_conv3x3 {shp}: max-abs {err:.4g} (max|ref| {scale:.4g}, "
              f"1 ulp {bf16_ulp(scale):.4g})")
    x = torch.zeros((1, 64, 128, 128), device=dev, dtype=torch.bfloat16)
    wt, b = torch.zeros((64, 64, 3, 3), device=dev), torch.zeros((64,), device=dev)
    refused = [(x.float(), wt, b), (x[:, :, :96, :96].contiguous(), wt, b),
               (x, torch.cat([wt, wt]), b), (x[:, :63].contiguous(), wt[:, :63], b),
               (x.half(), wt, b), (x.transpose(2, 3), wt, b)]
    before = pair_conv.LAUNCHES["pair_conv3x3"]
    for args in refused:
        try:
            pair_conv.pair_conv3x3(*args)
        except ValueError:
            continue
        raise AssertionError(f"pair_conv3x3 took {tuple(args[0].shape)} {args[0].dtype} "
                             f"with w {tuple(args[1].shape)}")
    check(pair_conv.LAUNCHES["pair_conv3x3"] == before, "a refused call launched")
    print(f"{len(refused)} gated-out shapes and dtypes raised ValueError")

    phase("11 FIR kernels against their plain versions, 256² shapes")
    check_fir_kernels(fir2x, {"down2x": DOWN_SHAPES_256, "up2x": UP_SHAPES_256}, max_abs)

    phase("12 CelebA-HQ 256 generator, full width")
    cfg2 = celeba256_config(Config)
    cfg2_32 = cfg2.replace(compute_dtype="float32")
    net2_cpu = randomize_parameters_(NCSNpp.from_config(cfg2_32), seed=1).eval()
    net2_32 = copy.deepcopy(net2_cpu).to(dev).eval()
    net2_16 = NCSNpp.from_config(cfg2)
    net2_16.load_state_dict(net2_cpu.state_dict())
    net2_16 = net2_16.to(dev).eval()
    n_params2 = sum(p.numel() for p in net2_cpu.parameters())
    shape2 = (BATCH_256, 3, 256, 256)
    g = torch.Generator(device=dev).manual_seed(5)
    x2 = torch.randn(shape2, generator=g, device=dev)
    zs2 = [torch.randn((BATCH_256, cfg2.nz), generator=g, device=dev) for _ in range(T_256)]
    noises2 = [torch.randn(shape2, generator=g, device=dev) for _ in range(T_256)]
    with torch.no_grad():
        out2 = net2_32(x2[:2], torch.full((2,), T_256 - 1, device=dev), zs2[0][:2])
    std2 = out2.std().item()
    print(f"NCSNpp (CelebA-HQ 256) {n_params2} parameters; forward {tuple(out2.shape)} "
          f"std {std2:.4f}")
    check(bool(torch.isfinite(out2).all()), "bad 256² generator output")
    check(std2 > 0.05, f"256² generator output std {std2}: weights are trivial")

    phase("13 T=2 sampler at 256², GPU f32 (TF32 off) against the CPU plain path, batch 2")
    coeff2_gpu = PosteriorCoefficients.create(T_256, cfg2.beta_min, cfg2.beta_max, device=dev)
    coeff2_cpu = PosteriorCoefficients.create(T_256, cfg2.beta_min, cfg2.beta_max, device="cpu")
    reset_counts()
    got2 = sample_from_model_with_noise(coeff2_gpu, net2_32, T_256, x2[:2],
                                        [z[:2] for z in zs2], [e[:2] for e in noises2])
    torch.cuda.synchronize()
    f32_launches = counts()
    t0 = time.perf_counter()
    want2 = sample_from_model_with_noise(coeff2_cpu, net2_cpu, T_256, x2[:2].cpu(),
                                         [z[:2].cpu() for z in zs2],
                                         [e[:2].cpu() for e in noises2])
    cpu2_s = time.perf_counter() - t0
    err256 = (got2.cpu() - want2).abs().max().item()
    print(f"256² sampler GPU vs CPU max-abs {err256:.3g} (CPU took {cpu2_s:.1f} s); "
          f"sample std {want2.std().item():.4f}; launches {f32_launches}")
    check(bool(torch.isfinite(got2).all()) and got2.shape == (2, 3, 256, 256), "bad output")
    check(err256 <= 2e-3, f"256² sampler GPU vs CPU max-abs {err256} > 2e-3")
    check(f32_launches == {"down2x": 20, "up2x": 20, "pair_conv3x3": 0},
          f"f32 256² sampler call: {f32_launches}")
    del net2_cpu, got2, want2

    phase("14 T=2 sampler at 256², bf16 against f32 on the GPU, batch 16")
    with torch.no_grad():
        ref32 = sample_from_model_with_noise(coeff2_gpu, net2_32, T_256, x2, zs2, noises2)
    reset_counts()
    got16 = sample_from_model_with_noise(coeff2_gpu, net2_16, T_256, x2, zs2, noises2)
    torch.cuda.synchronize()
    bf16_launches = counts()
    bf16_err = (got16.float() - ref32).abs().max().item()
    print(f"256² sampler bf16 vs f32 max-abs {bf16_err:.4g}; launches {bf16_launches}")
    check(bool(torch.isfinite(got16).all()) and got16.shape == shape2, "bad bf16 output")
    check(bf16_launches == {"down2x": 20, "up2x": 20, "pair_conv3x3": 46},
          f"bf16 256² sampler call: {bf16_launches}")
    check(bf16_err < 0.03, f"256² bf16 vs f32 max-abs {bf16_err} >= 0.03")
    del ref32, got16

    phase("15 main path: the sampler CLI on a CelebA-HQ 256 experiment")
    with tempfile.TemporaryDirectory() as tmp:
        exp = Path(tmp) / "saved_info" / "dd_gan" / "celeba_256" / "smoke256"
        exp.mkdir(parents=True)
        (exp / "content_args.json").write_text(json.dumps(cfg2.replace(exp="smoke256").to_dict()))
        torch.save({k: v.cpu() for k, v in net2_32.state_dict().items()}, exp / "netG_1.pth")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            test_cli.main(["--dataset", "celeba_256", "--exp", "smoke256", "--epoch_id", "1",
                           "--seed", "0"])
            torch.cuda.synchronize()
            main256_launches = counts()
            pngs = sorted((Path(tmp) / "generated_samples" / "celeba_256").glob("sample_*.png"))
            check(len(pngs) == BATCH_256, f"CLI wrote {len(pngs)} PNGs, expected {BATCH_256}")
            head = pngs[0].read_bytes()[:24]
            check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == (256).to_bytes(4, "big") * 2,
                  "CLI PNG is not a 256x256 PNG")
        finally:
            os.chdir(cwd)
    check(main256_launches == {"down2x": 20, "up2x": 20, "pair_conv3x3": 46},
          f"256² CLI run: {main256_launches}")
    print(f"CLI (CelebA-HQ 256): {len(pngs)} PNGs, launches {main256_launches}")

    phase("16 CelebA-HQ 256 timing")
    results256 = {}
    for label, net in (("bf16", net2_16), ("f32", net2_32)):
        call = test_cli.make_sampler(cfg2, net, BATCH_256, dev,
                                     torch.Generator(device=dev).manual_seed(6))
        results256[label] = sampler_ms(call, warmup=2, iters=5)
        print(f"sampler 256² {label}: {results256[label]:.3f} ms per T=2 call at batch "
              f"{BATCH_256} = {BATCH_256 / results256[label] * 1e3:.2f} samples/s")
    pair_rows = []
    for i, (c, s) in enumerate(PAIR_CONVS):
        shp = (BATCH_256, c, s, s)
        bufs = rotation(shp, torch.bfloat16, BATCH_256 * 64 * s * s, seed=7 + i)
        g = torch.Generator(device=dev).manual_seed(200 + i)
        wt = torch.randn((64, c, 3, 3), generator=g, device=dev) / math.sqrt(9 * c)
        b = torch.randn((64,), generator=g, device=dev)
        w16, b16 = wt.to(torch.bfloat16), b.to(torch.bfloat16)
        iters = max(20, 2 * len(bufs))
        with torch.no_grad():
            k_ms = device_ms(lambda x: pair_conv.pair_conv3x3(x, wt, b), bufs, iters)
            p_ms = device_ms(lambda x: pair_conv.pair_conv3x3_ref(x, wt, b), bufs, iters)
            l_ms = device_ms(lambda x: F.conv2d(x, w16, b16, padding=1), bufs, iters)
            want_k = pair_conv.pair_conv3x3_ref(bufs[0], wt, b).float()
            same = (F.conv2d(bufs[0], w16, b16, padding=1).float() - want_k).abs().max().item()
        check(same <= 2e-2 * want_k.abs().max().item(),
              f"library call for pair_conv3x3 computes another function ({same})")
        b_ms, b_by = pair_bound_ms(shp)
        pair_rows.append({"model": "celeba256", "shape": list(shp), "dtype": "bfloat16",
                          "per_forward": PAIR_CONVS[(c, s)], "ms": k_ms, "plain_ms": p_ms,
                          "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"pair_conv3x3 {shp}: kernel {k_ms:.4f} ms, plain {p_ms:.4f}, library "
              f"{l_ms:.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
              f"{2 * BATCH_256 * s * s * 64 * 9 * c / k_ms / 1e9:.1f} TFLOP/s")
        del bufs
    fir_rows256 = time_fir_kernels(fir2x, {"down2x": DOWN_SHAPES_256, "up2x": UP_SHAPES_256},
                                   "celeba256")

    phase("17 where the 256² sampler's time goes (torch.profiler, bf16)")
    profile256 = profile_sampler(test_cli.make_sampler(
        cfg2, net2_16, BATCH_256, dev, torch.Generator(device=dev).manual_seed(8)),
        results256["bf16"])

    phase("18 result")
    main_paths = {"flagship_cli": main_launches, "celeba256_cli": main256_launches}
    entries = []
    for name in ("down2x", "up2x", "pair_conv3x3"):
        if name == "pair_conv3x3":
            # per CelebA-HQ 256 generator forward: each shape as often as it runs
            rows = pair_rows
            total = {key: sum(r[key] * r["per_forward"] for r in rows)
                     for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        else:
            # per generator forward of each model: each shape once in bf16
            # (the h path) and once in f32 (the skip x path)
            rows = fir_rows[name] + fir_rows256[name]
            total = {key: sum(r[key] for r in rows)
                     for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in main_paths.values()),
            "launches_by_path": {k: p[name] for k, p in main_paths.items()},
            "max_abs_err": max_abs[name],
            **total,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            "shapes": rows,
        })
    print(json.dumps({
        "flagship": {"sampler_ms": results, "batch": BATCH, "steps": T,
                     "samples_per_s": {k: BATCH / v * 1e3 for k, v in results.items()},
                     "gpu_vs_cpu_max_abs": sampler_err, "profile": profile},
        "celeba256": {"sampler_ms": results256, "batch": BATCH_256, "steps": T_256,
                      "samples_per_s": {k: BATCH_256 / v * 1e3 for k, v in results256.items()},
                      "parameters": n_params2, "gpu_vs_cpu_max_abs": err256,
                      "bf16_vs_f32_max_abs": bf16_err, "profile": profile256},
        "build_s": build_s,
    }))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

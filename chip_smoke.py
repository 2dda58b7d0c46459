#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ddgan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It drives the flagship CIFAR-10 T=4 sampler
(NCSN++ nf 128, ch_mult 1 2 2 2, batch 64) with random seeded weights and
fails (non-zero exit) if any phase fails:

  1. print the card's name and power limit (nvidia-smi);
  2. build the fir2x CUDA kernel from ddgan_torch/csrc/fir2x.cu (sm_90a);
  3. hold down2x / up2x against their plain PyTorch versions at every
     flagship shape, f32 and bf16, symmetric and asymmetric taps;
  4. build the generator with non-trivial weights (output std > 0.05);
  5. run the T=4 sampler at batch 64 in f32 (TF32 off for matmuls and
     cuDNN) and compare with the port's plain path on the CPU, on the same
     weights, x_init, z's and noises (max-abs <= 2e-3);
  6. check the launch counts: 6 down2x and 6 up2x per generator forward,
     24 of each per sampler call;
  7. the main path: the sampler CLI (`ddgan_torch.cli.test_cli`) on a temp
     experiment with a content_args.json and netG_1.pth written here, with
     the launch counts reset before it and read after; then its FID-set
     loop `generate_samples`; the PNGs must appear;
  8. time the sampler (bf16 as the recipe sets it, and f32) and each kernel
     beside its plain version, the one PyTorch call that computes the same
     function, and its bound;
  9. profile two bf16 sampler calls: device time by kernel class and the
     share of a call's time that the device spends in kernels;
 10. print a `{"kernels": [...]}` line, then the `{"ok": true, ...}` line last.

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
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH = 64
T = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
FIR = (1.0, 3.0, 3.0, 1.0)
FIR_ASYM = (1.0, 2.0, 3.0, 4.0)
# flagship FIR inputs (B, C, H, W): the down blocks at 32/16/8, the up blocks at 4/8/16
DOWN_SHAPES = [(BATCH, 128, 32, 32), (BATCH, 256, 16, 16), (BATCH, 256, 8, 8)]
UP_SHAPES = [(BATCH, 256, 4, 4), (BATCH, 256, 8, 8), (BATCH, 256, 16, 16)]
REPLACES = {
    "down2x": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:133",
    "up2x": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:158",
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


def taps(kind: str, fir) -> tuple:
    """The separable taps the resample layer hands the kernel (gain 1)."""
    k = np.asarray(fir, np.float64)
    return tuple((k / k.sum() * (2 if kind == "up2x" else 1)).tolist())


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "ddgan_torch" / "csrc" / "fir2x.cu").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ddgan_torch.cli import test_cli
    from ddgan_torch.config import Config
    from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model_with_noise
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.ops import fir2x
    from ddgan_torch.utils import randomize_parameters_

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

    phase("2 build")
    t0 = time.perf_counter()
    fir2x.build(verbose=True)
    print(f"fir2x built in {time.perf_counter() - t0:.1f} s")

    phase("3 kernels against their plain versions")
    kernels = {"down2x": (fir2x.down2x, fir2x.down2x_ref, DOWN_SHAPES),
               "up2x": (fir2x.up2x, fir2x.up2x_ref, UP_SHAPES)}
    max_abs = {name: 0.0 for name in kernels}
    for name, (fn, ref, shapes) in kernels.items():
        for i_shape, shape in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                for fir in (FIR, FIR_ASYM):
                    g = torch.Generator(device="cuda").manual_seed(i_shape)
                    x = torch.randn(shape, generator=g, device=dev).to(dtype)
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
    fir2x.reset_launch_counts()
    with torch.no_grad():
        out = net32(x_init.to(dev), t_last.to(dev), zs[0].to(dev))
    torch.cuda.synchronize()
    fwd_launches = dict(fir2x.LAUNCHES)
    std = out.std().item()
    print(f"NCSNpp {n_params} parameters; forward {tuple(out.shape)} std {std:.4f}; "
          f"launches {fwd_launches}")
    check(out.shape == shape and bool(torch.isfinite(out).all()), "bad generator output")
    check(std > 0.05, f"generator output std {std}: weights are trivial")

    phase("5 T=4 sampler, GPU f32 (TF32 off) against the CPU plain path")
    coeff_gpu = PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device=dev)
    coeff_cpu = PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device="cpu")
    fir2x.reset_launch_counts()
    got = sample_from_model_with_noise(
        coeff_gpu, net32, T, x_init.to(dev), [z.to(dev) for z in zs], [n.to(dev) for n in noises])
    torch.cuda.synchronize()
    sampler_launches = dict(fir2x.LAUNCHES)
    t0 = time.perf_counter()
    want = sample_from_model_with_noise(coeff_cpu, net_cpu, T, x_init, zs, noises)
    cpu_s = time.perf_counter() - t0
    sampler_err = (got.cpu() - want).abs().max().item()
    print(f"sampler GPU vs CPU max-abs {sampler_err:.3g} (CPU took {cpu_s:.1f} s); "
          f"sample std {want.std().item():.4f}; launches {sampler_launches}")
    check(bool(torch.isfinite(got).all()) and got.shape == shape, "bad sampler output")
    check(sampler_err <= 2e-3, f"sampler GPU vs CPU max-abs {sampler_err} > 2e-3")

    phase("6 launch counts")
    check(fwd_launches == {"down2x": 6, "up2x": 6}, f"per forward: {fwd_launches}")
    check(sampler_launches == {"down2x": 24, "up2x": 24}, f"per sampler call: {sampler_launches}")

    phase("7 main path: the sampler CLI and its FID-set loop")
    with tempfile.TemporaryDirectory() as tmp:
        exp = Path(tmp) / "saved_info" / "dd_gan" / "cifar10" / "smoke"
        exp.mkdir(parents=True)
        (exp / "content_args.json").write_text(json.dumps(cfg.replace(exp="smoke").to_dict()))
        torch.save(net_cpu.state_dict(), exp / "netG_1.pth")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            fir2x.reset_launch_counts()
            test_cli.main(["--dataset", "cifar10", "--exp", "smoke", "--epoch_id", "1",
                           "--seed", "0"])
            torch.cuda.synchronize()
            main_launches = dict(fir2x.LAUNCHES)
            pngs = sorted((Path(tmp) / "generated_samples" / "cifar10").glob("sample_*.png"))
            check(len(pngs) == BATCH, f"CLI wrote {len(pngs)} PNGs, expected {BATCH}")
            head = pngs[0].read_bytes()[:24]
            check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == (32).to_bytes(4, "big") * 2,
                  "CLI PNG is not a 32x32 PNG")
            check(main_launches == {"down2x": 24, "up2x": 24}, f"CLI run: {main_launches}")

            args = test_cli.build_parser().parse_args(["--dataset", "cifar10", "--exp", "smoke"])
            loaded = test_cli.load_config(exp, args)
            gen = test_cli.load_generator(exp, loaded, 1, dev)
            sample = test_cli.make_sampler(loaded, gen, BATCH, dev,
                                           torch.Generator(device=dev).manual_seed(1))
            fir2x.reset_launch_counts()
            n = test_cli.generate_samples(sample, 100, BATCH, Path(tmp) / "fid_set", tag="smoke")
            loop_launches = dict(fir2x.LAUNCHES)
            n_png = len(list((Path(tmp) / "fid_set").glob("*.png")))
            check(n == 100 and n_png == 100, f"FID-set loop wrote {n_png} PNGs, expected 100")
            check(loop_launches == {"down2x": 48, "up2x": 48}, f"FID-set loop: {loop_launches}")
        finally:
            os.chdir(cwd)
    print(f"CLI: {len(pngs)} PNGs, launches {main_launches}; FID-set loop: {n_png} PNGs, "
          f"launches {loop_launches}")

    phase("8 timing")
    results = {}
    for label, net, dt in (("bf16", net16, torch.bfloat16), ("f32", net32, torch.float32)):
        rng = torch.Generator(device=dev).manual_seed(2)
        call = test_cli.make_sampler(cfg, net, BATCH, dev, rng)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        iters = 10
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        results[label] = ms
        print(f"sampler {label}: {ms:.3f} ms per T=4 call at batch {BATCH} = "
              f"{BATCH / ms * 1e3:.1f} samples/s")

    entries = []
    for name, (fn, ref, shapes) in kernels.items():
        lib = library_call(name, taps(name, FIR))
        k = taps(name, FIR)
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
                rows.append({"shape": list(shp), "dtype": str(dtype)[6:], "ms": k_ms,
                             "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                             "bound_by": b_by})
                print(f"{name} {shp} {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f}, "
                      f"library {l_ms:.4f}, bound {b_ms:.4f} ({b_by})")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "ddgan_torch/csrc/fir2x.cu",
            "replaces": REPLACES[name],
            "launches": main_launches[name],
            "max_abs_err": max_abs[name],
            # per generator forward: each shape once in bf16 (h) and once in f32 (x)
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "shapes": rows,
        })

    phase("9 where the sampler's time goes (torch.profiler, bf16)")
    profile = profile_sampler(test_cli.make_sampler(
        cfg, net16, BATCH, dev, torch.Generator(device=dev).manual_seed(4)), results["bf16"])

    phase("10 result")
    print(json.dumps({"sampler_ms": results, "batch": BATCH, "steps": T,
                      "samples_per_s": {k: BATCH / v * 1e3 for k, v in results.items()},
                      "gpu_vs_cpu_max_abs": sampler_err, "profile": profile}))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

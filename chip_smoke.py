#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ddgan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It drives the port's two sampler paths and its two
train steps with seeded weights and fails (non-zero exit) if any phase
fails. Each phase prints its wall time.

The flagship CIFAR-10 T=4 sampler (NCSN++ nf 128, ch_mult 1 2 2 2, batch 64):

  1. print the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from ddgan_torch/csrc/ (sm_90a), one nvcc
     each, started together: fir2x.cu and pair_conv3x3.cu, printing what
     ptxas reports for each kernel (registers, shared memory, spills) and
     one summary line per kernel;
  3. hold down2x / up2x against their plain PyTorch versions at every
     flagship shape, f32 and bf16, symmetric and asymmetric taps, and up2x
     at odd sides (5 x 7: the scalar path) and at D's 4-wide backward
     shape (4, 512, 4, 4);
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
     the same function, and its bound; per kernel, the lowest share of the
     bound over the shapes whose bound is >= 5 us, and the shapes where the
     library call is faster;
  9. profile two bf16 sampler calls: device time by kernel class and the
     share of a call's time that the device spends in kernels.

The CelebA-HQ 256 T=2 sampler (nf 64, ch_mult 1 1 2 2 4 4, 2 resblocks,
attention at 16, n_mlp 3; batch 16):

 10. hold pair_conv3x3 against its plain version at the four shapes of the
     generator's gated convs at batch 16 and at batch 2, and at an edge of
     its gate, (3, 2, 160, 160) (max-abs <= 1 bf16 ulp of max|ref|), and
     check that gated-out shapes and dtypes raise;
 11. hold down2x / up2x against their plain versions at the 256² shapes,
     down2x at bf16 rows of 24 bytes (its scalar path), and up2x at W 6
     (its scalar path at even sides), at odd H on the vector path and at
     rows wider than a warp (W 260);
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
     (`F.conv2d` in bf16, timed only), and the FIR kernels at 256², each
     with its TFLOP/s or GB/s and its share of the bound, and the summary
     lines of phase 8;
 17. profile two bf16 calls, with pair_conv3x3 as its own kernel class.

Training (`ddgan_torch.train.make_train_step`), the CelebA-HQ 256 recipe
(DiscriminatorLarge ngf 64, r1_gamma 2, lazy_reg 10, batch 4, bf16) and the
flagship one (DiscriminatorSmall, r1_gamma 0.02, lazy_reg 15, batch 64):

 19. down2x / up2x gradients against autograd through their plain versions,
     first order and R1's second order, at DiscriminatorLarge's (batch 4),
     DiscriminatorSmall's and both generators' shapes and at odd sides (a
     down2x output of 3 x 5, an up2x input of 5 x 7), f32 and bf16;
 20. pair_conv3x3's VJP against autograd through its plain version at the
     four gated shapes at batch 4 (dx within 1 bf16 ulp, dW within 2, db
     against float64), the dx route by the gate, and a refused input;
 21. the full-width 256² G and DiscriminatorLarge and their parameter counts;
 22. one D and G update (R1 on) in f32, TF32 off, on the GPU against the
     port's CPU path, batch 2: losses, penalty, every gradient, parameters;
 23. 11 bf16 steps of the 256² recipe at batch 4 from its init: launches
     per step by kernel and role (pair_conv3x3 64: 46 forward, 18 dx; FIR
     as `expected_fir_calls`), finite losses and parameters; 6 steps at
     lr 1e-7 against the same run in f32 within 5e-2 max |Δloss|;
 23b. step 0 of the recipe at its lr, where Adam's first, sign-like step
     moves D's output by tens and bf16 and f32 separate: bf16 with the
     kernels against bf16 with their plain versions on the card (losses,
     D's and G's gradients, errG against the same updated D) and against
     f32, D's step-0 gradient swapped between the precisions, which must
     carry errG across, and the plain versions' own bf16 step, which must
     separate from f32 too (`first_step_attribution`);
 24. the flagship step: f32 GPU against CPU at batch 4, then 3 bf16 steps at
     batch 64 with dropout 0.1 (no pair_conv3x3);
 25. ms per bf16 step (R1 steps and the others apart), samples/s, peak
     memory, and each kernel's time per step by role beside its bound, its
     plain version and the library call (K2's dx as the step launches it:
     the forward weight, flipped in the kernel, no bias), each launch shape
     on its own line, and per role the summary lines of phase 8;
 26. profile two bf16 256² steps: device time by kernel class, K1 and K2 by
     role, the busy share and the kernel launches per step;
 27. print the result, a `{"kernels": [...]}` line (the forward entries and
     one per backward role), and the `{"ok": true, ...}` line last.

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


def expected_fir_calls(n_d: int, n_g: int, r1: bool, shared: bool) -> dict:
    """FIR calls of one train step by pattern and role, for a discriminator
    with `n_d` downsampling blocks and a generator with `n_g` down and `n_g`
    up resblocks. Each D forward runs down2x twice per downsampling block
    (the block's output and its skip input); D runs on the fakes and on
    x_t in the D update, once more on x_t for a recomputed (not shared) R1,
    and on the fakes of the G update. Every D forward is differentiated
    once more in its update, and an R1 step differentiates D(x_t) a second
    time for the penalty, whose own backward is the second order. G runs
    twice (the D update's fakes under no_grad, the G update) and is
    differentiated once. The backward of down2x is an up2x call and the
    backward of up2x a down2x call (`ddgan_torch/ops/fir2x.py`)."""
    per_d = 2 * n_d
    d_fwd = 3 + int(r1 and not shared)
    d_bwd = d_fwd + int(r1)
    return {
        "down2x": {"forward": d_fwd * per_d + 2 * 2 * n_g, "backward": 2 * n_g,
                   "second_order": per_d if r1 else 0},
        "up2x": {"forward": 2 * 2 * n_g, "backward": d_bwd * per_d + 2 * n_g,
                 "second_order": 0},
    }


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


PHASE_S: dict = {}
_PHASE_T = [time.perf_counter(), None]


def phase(name: str) -> None:
    """Start phase `name`; print the wall time of the one before."""
    now = time.perf_counter()
    if _PHASE_T[1] is not None:
        PHASE_S[_PHASE_T[1]] = now - _PHASE_T[0]
        print(f"   ({_PHASE_T[1].split()[0]}: {now - _PHASE_T[0]:.1f} s)", flush=True)
    _PHASE_T[:] = [now, name]
    print(f"== {name}", flush=True)


def flagship_config(Config):
    """The CIFAR-10 recipe of `__graft_entry__._flagship_config` (weights random)."""
    return Config(
        dataset="cifar10", image_size=32, num_channels=3,
        num_channels_dae=128, ch_mult=[1, 2, 2, 2], num_res_blocks=2,
        attn_resolutions=[16], nz=100, z_emb_dim=256, n_mlp=4,
        t_emb_dim=256, ngf=64, num_timesteps=T, batch_size=BATCH,
        lr_d=1.25e-4, lr_g=1.6e-4, r1_gamma=0.02, lazy_reg=15,
        ema_decay=0.9999, dropout=0.1, beta1_g=0.5, beta2_g=0.9,
        beta1_d=0.5, beta2_d=0.9, compute_dtype="bfloat16",
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
    if "fir2x" in low or "down2x_kernel" in low or "up2x_kernel" in low:
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
        if (us > 0 and str(ev.device_type).endswith("CUDA")
                and not getattr(ev, "is_user_annotation", False)):
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


def ptxas_summary(report: str) -> list:
    """One line per kernel of a ptxas report: registers and spill bytes."""
    import re

    lines, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = name = m.group(1)
            for d in re.finditer(r"\d+", mangled):  # <length><name> in the mangled name
                end = d.end() + int(d.group())
                if mangled[d.end():end].endswith("_kernel"):
                    name = mangled[d.end():end]
                    t = re.match(r"I(f|13__nv_bfloat16)Lb([01])E", mangled[end:])
                    if t:
                        name += (f"<{'float' if t.group(1) == 'f' else 'bf16'}, "
                                 f"{'vector' if t.group(2) == '1' else 'scalar'}>")
                    break
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers; {spill}")
            name = None
    return lines


def share_summary(label: str, rows: list) -> dict:
    """The lowest share of the bound over `rows` whose bound is >= 5 us, and
    the rows where the library call is faster than the kernel."""
    big = [r for r in rows if r["bound_ms"] >= 0.005]
    low = min(big, key=lambda r: r["bound_ms"] / r["ms"]) if big else None
    slower = [f"{tuple(r['shape'])} {r['dtype']}" for r in rows if r["ms"] >= r["library_ms"]]
    out = {"lowest_share": low["bound_ms"] / low["ms"] if low else None,
           "at": f"{tuple(low['shape'])} {low['dtype']}" if low else None,
           "shapes_with_bound_ge_5us": len(big), "shapes": len(rows),
           "library_faster_at": slower}
    print(f"{label}: lowest share of the bound over the {len(big)} of {len(rows)} shapes with a "
          f"bound >= 5 us: " + (f"{out['lowest_share']:.1%} at {out['at']}" if low else "none")
          + f"; library call faster at {len(slower)} shapes {slower}")
    return out


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
                moved = math.prod(shp) * (1.25 if name == "down2x" else 5) * bufs[0].element_size()
                print(f"{name} {shp} {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f}, "
                      f"library {l_ms:.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
                      f"{moved / k_ms / 1e6:.0f} GB/s, {b_ms / k_ms:.1%} of its bound")
                del bufs
        rows_by_kind[name] = rows
        share_summary(f"{name} ({model})", rows)
    return rows_by_kind


# ---------------------------------------------------------------------------
# training phases
TRAIN_BATCH_256 = 4  # the CelebA-HQ 256 recipe's batch per chip (tools/bench_extra.py:173)
TRAIN_STEPS_256 = 11  # R1 fires at steps 0 and 10 (lazy_reg 10)
TRAIN_BATCH = 64  # the flagship recipe's batch
TRAJ_LR = 1e-7  # the lr of the bounded bf16-vs-f32 trajectory
# down2x inputs of DiscriminatorLarge (ngf 64) at batch 4: each block's output
# path and skip input, 256² down to 8²
D_LARGE_DOWN = [(4, 256, 256, 256), (4, 128, 256, 256), (4, 512, 128, 128), (4, 256, 128, 128),
                (4, 512, 64, 64), (4, 512, 32, 32), (4, 512, 16, 16), (4, 512, 8, 8)]
# down2x inputs of DiscriminatorSmall (ngf 64) at batch 64
D_SMALL_DOWN = [(64, 256, 32, 32), (64, 128, 32, 32), (64, 512, 16, 16), (64, 256, 16, 16),
                (64, 512, 8, 8)]
REPLACES_BWD = {
    "up2x.backward": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:142",  # _down2x_bwd
    "down2x.backward": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:167",  # _up2x_bwd
    "down2x.second_order": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:167",
    "pair_conv3x3.dx": "ddgan_tpu/ops/experimental/pallas_conv.py:208",  # _bwd
}


def out_shape(kind: str, shape) -> tuple:
    n, c, h, w = shape
    return (n, c, h // 2, w // 2) if kind == "down2x" else (n, c, 2 * h, 2 * w)


def check_fir_grads(fir2x, cases, max_abs: dict) -> None:
    """First- and second-order gradients of each FIR kernel against autograd
    through its plain version: the grad in x of sum(f(a·x)²·r), and the
    grad in the upstream scale a of ‖that grad‖² (R1's grad-of-grad).
    float32: max-abs ≤ 1e-5 of max|ref| and 1e-5 relative for the scalar;
    bfloat16: 2e-2 of max|ref| and 2e-2 relative (one rounding per pass,
    taps rounded to bf16 in the plain version)."""
    for name, shape in cases:
        fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                              fir2x.up2x_ref)
        for dtype in (torch.float32, torch.bfloat16):
            for fir in (FIR, FIR_ASYM):
                k = taps(name, fir)
                g = torch.Generator(device="cuda").manual_seed(sum(shape))
                x = torch.randn(shape, generator=g, device="cuda").to(dtype)
                r = torch.randn(out_shape(name, shape), generator=g, device="cuda").to(dtype)
                res = []
                for f in (fn, ref):
                    a = torch.ones((), device="cuda", dtype=dtype, requires_grad=True)
                    xi = a * x
                    (gx,) = torch.autograd.grad((f(xi, k).square() * r).sum(), xi,
                                                create_graph=True)
                    (ga,) = torch.autograd.grad(gx.float().square().sum(), a)
                    res.append((gx.detach().float(), ga.float().item()))
                torch.cuda.synchronize()
                (gx, ga), (gx_r, ga_r) = res
                scale = gx_r.abs().max().item()
                err, err2 = (gx - gx_r).abs().max().item(), abs(ga - ga_r) / abs(ga_r)
                tol = 1e-5 if dtype == torch.float32 else 2e-2
                if dtype == torch.float32:
                    max_abs[name + ".grad"] = max(max_abs.get(name + ".grad", 0.0), err)
                check(err <= tol * scale and err2 <= tol,
                      f"{name} grads {shape} {dtype} {fir}: {err} of {scale}, second order {err2}")
        print(f"{name} {shape}: first and second order grads match the plain version "
              f"(f32 and bf16, both tap sets)")


def check_pair_vjp(pair_conv, shapes) -> float:
    """pair_conv3x3's VJP against autograd through its plain version: dx
    within 1 bf16 ulp of max|ref| (both round f32 sums once), dW within 2
    ulp (bf16-rounded on both sides), db within 1e-4 of the float64 sum.
    Returns the largest dx error (max-abs) of the kernel's dx launches."""
    worst = 0.0
    for i, shape in enumerate(shapes):
        n, c, h, w = shape
        g0 = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(shape, generator=g0, device="cuda").to(torch.bfloat16)
        wt = torch.randn((64, c, 3, 3), generator=g0, device="cuda") / math.sqrt(9 * c)
        b = torch.randn((64,), generator=g0, device="cuda")
        gy = torch.randn((n, 64, h, w), generator=g0, device="cuda").to(torch.bfloat16)
        grads = []
        pair_conv.reset_launch_counts()
        for f in (pair_conv.pair_conv3x3, pair_conv.pair_conv3x3_ref):
            xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, wt, b))
            f(xi, wi, bi).backward(gy)
            grads.append((xi.grad.float(), wi.grad, bi.grad))
        torch.cuda.synchronize()
        gated = c == 64
        check(pair_conv.CALLS == {"forward": 1, "dx": int(gated), "dx_library": int(not gated)}
              and pair_conv.LAUNCHES["pair_conv3x3"] == 1 + gated, f"{shape}: routes {pair_conv.CALLS}")
        (dx, dw, db), (dx_r, dw_r, db_r) = grads
        ulp = bf16_ulp(dx_r.abs().max().item())
        err = (dx - dx_r).abs().max().item()
        if gated:
            worst = max(worst, err)
        dw_err = (dw - dw_r).abs().max().item()
        dw_ulp = bf16_ulp(dw_r.abs().max().item())
        db_true = gy.double().sum((0, 2, 3))
        db_err = (db.double() - db_true).abs().max().item() / db_true.abs().max().item()
        check(err <= ulp and dw_err <= 2 * dw_ulp and db_err <= 1e-4,
              f"pair_conv3x3 VJP {shape}: dx {err} (ulp {ulp}), dW {dw_err} (ulp {dw_ulp}), "
              f"db {db_err}")
        print(f"pair_conv3x3 VJP {shape}: dx {'kernel' if gated else 'library'} max-abs "
              f"{err:.4g} (1 ulp {ulp:.4g}); dW {dw_err:.4g} (1 ulp {dw_ulp:.4g}); db rel {db_err:.3g}")
    return worst


def build_trainer(cfg, gen_sd, disc_sd, dev, dtype_name: str):
    """(state, step) of a config on `dev` in `dtype_name`, from state dicts."""
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.train import ClippedAdam, create_train_state, make_train_step

    c = cfg.replace(compute_dtype=dtype_name)
    gen, disc = NCSNpp.from_config(c), build_discriminator(c)
    gen.load_state_dict(gen_sd)
    disc.load_state_dict(disc_sd)
    state = create_train_state(
        gen.to(dev), disc.to(dev),
        ClippedAdam(gen.parameters(), c.beta1_g, c.beta2_g, c.weight_decay_G, c.grad_clip_norm),
        ClippedAdam(disc.parameters(), c.beta1_d, c.beta2_d, c.weight_decay_D, c.grad_clip_norm),
        use_ema=c.use_ema,
    )
    step = make_train_step(
        DiffusionCoefficients.create(c.num_timesteps, c.beta_min, c.beta_max, device=dev),
        PosteriorCoefficients.create(c.num_timesteps, c.beta_min, c.beta_max, device=dev),
        num_timesteps=c.num_timesteps, nz=c.nz, r1_gamma=c.r1_gamma, lazy_reg=c.lazy_reg,
        ema_decay=c.ema_decay, use_ema=c.use_ema,
    )
    return state, step


def real_batch(cfg, batch: int, seed: int) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.uniform(-1, 1, (batch, cfg.num_channels, cfg.image_size,
                                                cfg.image_size)).astype(np.float32))


def compare_step_gpu_cpu(cfg, gen_sd, disc_sd, batch: int, seed: int) -> dict:
    """One train step (R1 on, step 0) in float32 with TF32 off on the GPU and
    on the port's CPU plain path, same weights and injected draws. Losses
    within 1e-4 relative, the penalty within 1e-3; every gradient tensor
    within 1e-3 of its max-abs (floored at 1e-6 of the network's largest
    gradient, for gradients that are zero in exact arithmetic); parameters
    within 2·lr + 1e-6: Adam's first step moves each by about lr·sign(g), so
    a gradient at the noise floor may flip its update."""
    from ddgan_torch.train import StepDraws, draw_step

    dev = torch.device("cuda")
    sg, step_g = build_trainer(cfg, gen_sd, disc_sd, dev, "float32")
    sc, step_c = build_trainer(cfg, gen_sd, disc_sd, torch.device("cpu"), "float32")
    real = real_batch(cfg, batch, seed)
    draws = draw_step(real, cfg.num_timesteps, cfg.nz, torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    m_g = step_g(sg, real.to(dev), None, cfg.lr_g, cfg.lr_d,
                 draws=StepDraws(*(d.to(dev) for d in draws)))
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_c = step_c(sc, real, None, cfg.lr_g, cfg.lr_d, draws=draws)
    cpu_s = time.perf_counter() - t0
    out = {"gpu_s": gpu_s, "cpu_s": cpu_s, "losses": {}, "grads": {}, "params": {}}
    for name in m_g._fields:
        a, b = float(getattr(m_g, name)), float(getattr(m_c, name))
        out["losses"][name] = (a, b)
        tol = 1e-3 if name == "grad_penalty" else 1e-4
        check(np.isfinite(a) and abs(a - b) <= tol * abs(b) + 1e-12, f"{name}: GPU {a} CPU {b}")
    check(out["losses"]["grad_penalty"][1] > 0, "R1 did not fire")
    for net, lr in (("gen", cfg.lr_g), ("disc", cfg.lr_d)):
        pg = dict(getattr(sg, net).named_parameters())
        pc = dict(getattr(sc, net).named_parameters())
        floor = 1e-6 * max(float(p.grad.abs().max()) for p in pc.values())
        errs = {k: float((pg[k].grad.cpu() - p.grad).abs().max())
                / max(float(p.grad.abs().max()), floor) for k, p in pc.items()}
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        dp = max(float((pg[k].detach().cpu() - p.detach()).abs().max()) for k, p in pc.items())
        out["grads"][net] = {"tensors": len(errs), "worst": worst}
        out["params"][net] = {"max_abs": dp, "bound": 2 * lr + 1e-6}
        check(worst[0][1] <= 1e-3, f"{net} gradient GPU vs CPU: {worst}")
        check(dp <= 2 * lr + 1e-6, f"{net} parameters GPU vs CPU: {dp} > 2·lr")
    print(json.dumps({"gpu_vs_cpu_step": out}))
    return out


class PlainKernels:
    """While active, the FIR and pair_conv3x3 Functions run their plain
    versions on the card in place of the kernels (the autograd structure,
    the routes and the calls by role stay)."""

    def __init__(self, fir2x, pair_conv):
        self.fir2x, self.pair_conv = fir2x, pair_conv

    def __enter__(self):
        fir2x, pair_conv = self.fir2x, self.pair_conv
        self._saved = (fir2x._resample, pair_conv._conv)

        def fir(name, x, k1d, order):
            fir2x.CALLS[name][fir2x.ROLES[min(order, 2)]] += 1
            return fir2x.down2x_ref(x, k1d) if name == "down2x" else fir2x.up2x_ref(x, k1d)

        fir2x._resample, pair_conv._conv = fir, pair_conv.pair_conv3x3_ref
        return self

    def __exit__(self, *exc):
        self.fir2x._resample, self.pair_conv._conv = self._saved


def rel_l2(a: list, b: list) -> float:
    """‖a − b‖ / ‖b‖ over lists of tensors taken as one vector."""
    num = sum(float((x.float() - y.float()).square().sum()) for x, y in zip(a, b))
    return math.sqrt(num / sum(float(y.float().square().sum()) for y in b))


def first_step(cfg, g_sd, d_sd, real, draws, dtype_name: str, fir2x, pair_conv, *,
               plain: bool = False, d_grads: list | None = None) -> dict:
    """One train step (step 0: R1 on) of `cfg` at its lrs on the card from
    the given weights and draws. Records D's and G's raw gradients (before
    the clip) as each optimizer steps. `plain`: the kernels' plain versions
    in their place. `d_grads`: D's update uses these gradients instead of
    its own (which are still recorded)."""
    st, stp = build_trainer(cfg, g_sd, d_sd, real.device, dtype_name)
    rec = {}

    def recording(opt, key, swap):
        inner = opt.step

        def step(lr):
            rec[key] = [p.grad.detach().clone() for p in opt.params]
            if swap is not None:
                for p, g in zip(opt.params, swap):
                    p.grad = g.clone()
            inner(lr)
        opt.step = step

    recording(st.opt_D, "gD", d_grads)
    recording(st.opt_G, "gG", None)
    fir2x.reset_launch_counts()
    pair_conv.reset_launch_counts()
    if plain:
        with PlainKernels(fir2x, pair_conv):
            m = stp(st, real, None, cfg.lr_g, cfg.lr_d, draws=draws)
    else:
        m = stp(st, real, None, cfg.lr_g, cfg.lr_d, draws=draws)
    torch.cuda.synchronize()
    rec["launches"] = sum(fir2x.LAUNCHES.values()) + pair_conv.LAUNCHES["pair_conv3x3"]
    rec.update({k: float(v) for k, v in m._asdict().items()})
    return rec


def first_step_attribution(cfg, g_sd, d_sd, real, fir2x, pair_conv) -> dict:
    """The recipe's step 0 at its lr, from its init, same draws in every run:
    bf16 with the kernels (b), bf16 with their plain versions on the card
    (po; p: the same with b's D gradient, so that p's G update sees b's
    updated D), f32 (f); then D's gradient swapped between the precisions
    (f32 with b's: fb; bf16 with f's: bf), and f32 with f's D gradient plus
    Gaussian noise of b − f's size, tensor by tensor (fn, printed). errG is
    taken after the step's D update, against the updated D.

    Bounds (each fails the phase):
    - the losses before the update: b against f within 5e-2 (the
      trajectory bound); b against p within 1e-3 relative (the penalty,
      a grad-of-grad through every FIR in bf16, 2e-2);
    - D's gradient: b against p no farther than b against f (relative L2);
    - errG b against p within 1e-2 relative, G's gradient b against p no
      farther than b against fb (f32 against the same updated D);
    - the gap |errG_b − errG_f| is larger than 1; swapping D's gradient
      carries errG across to within a quarter of the gap
      (|errG_fb − errG_b|, |errG_bf − errG_f|); and the plain versions'
      own bf16 step lands at least a quarter of the gap away from f32
      (|errG_po − errG_f|). So what separates the precisions is D's step-0
      gradient in bf16, through Adam's sign-like first step, with the
      kernels or without them; the kernels' rounding and the plain
      versions' land at different places too (printed)."""
    from ddgan_torch.train import draw_step

    # the draws of phase 23's step 0 (its generator, seed 15): its first D
    # update moves D's output on the G update's fakes to about -60, so errG
    # is ~60. Other draws can move it to about +30, where errG saturates at
    # ~1e-13 and the comparison is vacuous.
    draws = draw_step(real, cfg.num_timesteps, cfg.nz,
                      torch.Generator(device=real.device).manual_seed(15))
    args = (cfg, g_sd, d_sd, real, draws)
    b = first_step(*args, "bfloat16", fir2x, pair_conv)
    check(b["launches"] > 0, "the bf16 step launched no kernel")
    p = first_step(*args, "bfloat16", fir2x, pair_conv, plain=True, d_grads=b["gD"])
    po = first_step(*args, "bfloat16", fir2x, pair_conv, plain=True)
    check(p["launches"] == 0 and po["launches"] == 0, "a plain run launched a kernel")
    f = first_step(*args, "float32", fir2x, pair_conv)
    fb = first_step(*args, "float32", fir2x, pair_conv, d_grads=b["gD"])
    bf = first_step(*args, "bfloat16", fir2x, pair_conv, d_grads=f["gD"])
    gen = torch.Generator(device=real.device).manual_seed(26)
    noisy = [gf + torch.randn(gf.shape, generator=gen, device=gf.device)
             * float((gb - gf).square().mean().sqrt()) for gf, gb in zip(f["gD"], b["gD"])]
    fn = first_step(*args, "float32", fir2x, pair_conv, d_grads=noisy)
    flips = (sum(int((torch.sign(x) != torch.sign(y)).sum()) for x, y in zip(b["gD"], f["gD"]))
             / sum(x.numel() for x in f["gD"]))
    losses = ("errD_real", "errD_fake", "grad_penalty", "errG")
    out = {"runs": {k: {n: r[n] for n in losses} for k, r in
                    (("b", b), ("p", p), ("po", po), ("f", f), ("fb", fb), ("bf", bf),
                     ("fn", fn))},
           "d_grad_rel_l2": {"b_vs_p": rel_l2(b["gD"], p["gD"]), "b_vs_f": rel_l2(b["gD"], f["gD"])},
           "g_grad_rel_l2": {"b_vs_p": rel_l2(b["gG"], p["gG"]),
                             "b_vs_fb": rel_l2(b["gG"], fb["gG"])},
           "d_grad_sign_flips_b_vs_f": flips}
    gap = abs(b["errG"] - f["errG"])
    out["errG_gap_b_f"] = gap
    print(json.dumps({"first_step_attribution": out}))
    for n in losses[:3]:
        tol = 2e-2 if n == "grad_penalty" else 1e-3
        check(abs(b[n] - f[n]) <= 5e-2, f"{n}: bf16 {b[n]} f32 {f[n]}")
        check(abs(b[n] - p[n]) <= tol * abs(p[n]), f"{n}: kernels {b[n]} plain {p[n]}")
    check(out["d_grad_rel_l2"]["b_vs_p"] <= out["d_grad_rel_l2"]["b_vs_f"],
          f"D gradient, kernels vs plain: {out['d_grad_rel_l2']}")
    check(abs(b["errG"] - p["errG"]) <= 1e-2 * abs(p["errG"]),
          f"errG kernels {b['errG']} plain {p['errG']}")
    check(out["g_grad_rel_l2"]["b_vs_p"] <= out["g_grad_rel_l2"]["b_vs_fb"],
          f"G gradient, kernels vs plain: {out['g_grad_rel_l2']}")
    check(gap > 1.0, f"bf16 and f32 do not separate at the recipe's lr ({gap})")
    check(abs(fb["errG"] - b["errG"]) <= gap / 4 and abs(bf["errG"] - f["errG"]) <= gap / 4,
          f"swapping D's gradient does not carry errG across: {out['runs']}")
    check(abs(po["errG"] - f["errG"]) >= gap / 4,
          f"without the kernels bf16 does not separate from f32: {out['runs']}")
    return out


class LaunchRecorder:
    """Records every FIR and pair_conv3x3 launch (kernel.role, shape, dtype),
    in launch order, while active, by wrapping the wrappers' inner routes."""

    def __init__(self, fir2x, pair_conv):
        self.fir2x, self.pair_conv = fir2x, pair_conv
        self.launches: list = []

    def __enter__(self):
        fir_inner, pair_inner = self.fir2x._resample, self.pair_conv._apply
        self._saved = (fir_inner, pair_inner)
        roles = self.fir2x.ROLES

        def fir(name, x, k1d, order):
            return self._run(f"{name}.{roles[min(order, 2)]}", x, fir_inner, name, x, k1d, order)

        def pair(x, w, b, role, flip=False):
            return self._run(f"pair_conv3x3.{role}", x, pair_inner, x, w, b, role, flip)

        self.fir2x._resample, self.pair_conv._apply = fir, pair
        return self

    def _run(self, key, x, fn, *args):
        self.launches.append((key, tuple(x.shape), str(x.dtype)[6:]))
        return fn(*args)

    def __exit__(self, *exc):
        self.fir2x._resample, self.pair_conv._apply = self._saved

    def counts(self) -> dict:
        out: dict = {}
        for key in self.launches:
            out[key] = out.get(key, 0) + 1
        return out


def profile_steps(call, step_ms: float, fir2x, pair_conv, calls: int = 2) -> dict:
    """Device time by kernel class over `calls` train steps, K1 and K2 split
    by role, and the share of a step (`step_ms`, timed without the
    profiler) that the device spends in kernels. User annotations (the
    optimizer's range) are not kernels and are left out. The kernels run in
    order on one stream, so the n-th FIR (pair_conv3x3) kernel on the device
    is the n-th FIR (pair_conv3x3) launch that the recorder saw."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with LaunchRecorder(fir2x, pair_conv) as rec, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((ev for ev in prof.events() if str(ev.device_type).endswith("CUDA")
                      and not getattr(ev, "is_user_annotation", False)),
                     key=lambda ev: ev.time_range.start)
    by_class: dict[str, float] = {}
    by_role: dict[str, float] = {}
    for cls in ("fir2x", "pair_conv3x3"):
        evs = [ev for ev in kernels if _kernel_class(ev.name) == cls]
        keys = [k for k, _, _ in rec.launches if k.startswith("pair") == (cls == "pair_conv3x3")]
        check(len(evs) == len(keys), f"profile: {len(evs)} {cls} kernels, {len(keys)} launches")
        for ev, key in zip(evs, keys):
            by_role[key] = by_role.get(key, 0.0) + ev.time_range.elapsed_us() / calls / 1e3
    for ev in kernels:
        cls = _kernel_class(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + ev.time_range.elapsed_us() / calls / 1e3
    busy = sum(by_class.values())
    out = {"calls": calls, "step_ms": step_ms, "profiled_wall_ms_per_step": wall_ms / calls,
           "device_busy_ms_per_step": busy, "device_busy_share": busy / step_ms,
           "kernel_launches_per_step": len(kernels) // calls,
           "ms_per_step_by_class": dict(sorted(by_class.items())),
           "ms_per_step_by_role": dict(sorted(by_role.items()))}
    print(json.dumps({"train_profile": out}))
    return out


def time_launches(fir2x, pair_conv, counts_by_step: dict) -> dict:
    """Each role's device time per step: every distinct (kernel, shape,
    dtype) launch of the recorded steps timed alone (CUDA events, L2 cold),
    beside its plain version, the library call and its bound, summed over
    the step's launches."""
    timed: dict = {}
    for counts in counts_by_step.values():
        for (key, shape, dt) in counts:
            if (key, shape, dt) in timed:
                continue
            kernel, role = key.split(".")
            dtype = getattr(torch, dt)
            n_in = math.prod(shape)
            if kernel in ("down2x", "up2x"):
                fn, ref = (fir2x.down2x, fir2x.down2x_ref) if kernel == "down2x" else (
                    fir2x.up2x, fir2x.up2x_ref)
                k = taps(kernel, FIR)
                bufs = rotation(shape, dtype, n_in // 4 if kernel == "down2x" else 4 * n_in, seed=7)
                lib = library_call(kernel, k)
                iters = max(30, 2 * len(bufs))
                with torch.no_grad():
                    row = {"ms": device_ms(lambda x: fn(x, k), bufs, iters),
                           "plain_ms": device_ms(lambda x: ref(x, k), bufs, iters),
                           "library_ms": device_ms(lib, bufs, iters)}
                row["bound_ms"], row["bound_by"] = fir_bound_ms(kernel, shape, dtype)
            else:
                n, c, h, w = shape
                bufs = rotation(shape, torch.bfloat16, n * 64 * h * w, seed=8)
                g0 = torch.Generator(device="cuda").manual_seed(9)
                wt = torch.randn((64, c, 3, 3), generator=g0, device="cuda") / math.sqrt(9 * c)
                w16 = wt.to(torch.bfloat16)
                iters = max(20, 2 * len(bufs))
                if role == "dx":
                    # as the step launches it: the forward weight (64, 64) with
                    # the in-kernel flip and no bias; the library's input
                    # gradient of the forward conv
                    b, flip = None, True
                    lib = lambda y: torch.nn.grad.conv2d_input((n, c, h, w), w16, y, padding=1)
                else:
                    b, flip = torch.zeros((64,), device="cuda"), False
                    lib = lambda y: F.conv2d(y, w16, padding=1)
                with torch.no_grad():
                    row = {"ms": device_ms(lambda y: pair_conv._conv(y, wt, b, flip), bufs, iters),
                           "plain_ms": device_ms(lambda y: pair_conv.pair_conv3x3_ref(y, wt, b, flip),
                                                 bufs, iters),
                           "library_ms": device_ms(lib, bufs, iters)}
                row["bound_ms"], row["bound_by"] = pair_bound_ms(shape)
            timed[(key, shape, dt)] = {**row, "shape": list(shape), "dtype": dt}
            print(f"  {key} {shape} {dt}: kernel {row['ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}), "
                  f"{row['bound_ms'] / row['ms']:.1%} of its bound")
            del bufs
    for key in sorted({k for k, _, _ in timed}):
        if key.split(".")[0] in ("down2x", "up2x"):
            share_summary(key, [r for (k, _, _), r in timed.items() if k == key])
    roles: dict = {}
    for step_name, counts in counts_by_step.items():
        for (key, shape, dt), n in counts.items():
            r = roles.setdefault(key, {}).setdefault(step_name, {
                "launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "bound_by": set()})
            r["launches"] += n
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                r[f] += n * timed[(key, shape, dt)][f]
            r["bound_by"].add(timed[(key, shape, dt)]["bound_by"])
    for per_step in roles.values():
        for r in per_step.values():
            r["bound_by"] = "bytes" if r["bound_by"] == {"bytes"} else "operations"
    return roles


def time_steps(state, step, real, rng, n: int) -> dict:
    """ms per step (CUDA events around each step, the first two of each kind
    excluded as warm-up), for R1 steps and the others apart: the step
    counter is set before each call so that R1 fires or not. Also the peak
    device memory of an R1 step."""
    lr = 1e-4
    out = {}
    for label in ("r1_step", "plain_step"):
        times = []
        for i in range(n + 2):
            state.step = 0 if label == "r1_step" else 1
            if label == "r1_step" and i == 1:
                torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, real, rng, lr, lr)
            end.record()
            torch.cuda.synchronize()
            if label == "r1_step" and i == 1:
                out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if i >= 2:
                times.append(start.elapsed_time(end))
        out[label] = float(np.mean(times))
    return out


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
    from ddgan_torch.ops import _nvcc, fir2x, pair_conv
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
    for source, report in sorted(_nvcc.PTXAS.items()):
        for line in ptxas_summary(report):
            print(f"ptxas {source}: {line}")

    phase("3 FIR kernels against their plain versions, flagship shapes")
    max_abs = {"down2x": 0.0, "up2x": 0.0, "pair_conv3x3": 0.0}
    # and up2x at odd sides (W 7: the scalar path) and at D's 4-wide VJP shape
    check_fir_kernels(fir2x, {"down2x": DOWN_SHAPES,
                              "up2x": UP_SHAPES + [(1, 2, 5, 7), (4, 512, 4, 4)]}, max_abs)

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
    # and an edge of the gate: 2 input channels (one 16-channel step, mostly
    # zero-filled) and a 160-wide map (its last 64-column tile half outside)
    pair_shapes = [(BATCH_256, c, s, s) for (c, s) in PAIR_CONVS] + [(2, 64, 128, 128),
                                                                     (3, 2, 160, 160)]
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
    # and a down2x input whose bf16 rows are 24 bytes (W 12): the scalar path;
    # up2x at W 6 (the scalar path at even sides), at odd H on the vector
    # path, and at rows wider than a warp (halo loads at the warps' edges)
    check_fir_kernels(fir2x, {"down2x": DOWN_SHAPES_256 + [(2, 3, 10, 12)],
                              "up2x": UP_SHAPES_256 + [(3, 5, 6, 6), (2, 3, 9, 12), (1, 3, 7, 260)]},
                      max_abs)

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
              f"{2 * BATCH_256 * s * s * 64 * 9 * c / k_ms / 1e9:.1f} TFLOP/s, "
              f"{b_ms / k_ms:.1%} of its bound")
        del bufs
    fir_rows256 = time_fir_kernels(fir2x, {"down2x": DOWN_SHAPES_256, "up2x": UP_SHAPES_256},
                                   "celeba256")

    phase("17 where the 256² sampler's time goes (torch.profiler, bf16)")
    profile256 = profile_sampler(test_cli.make_sampler(
        cfg2, net2_16, BATCH_256, dev, torch.Generator(device=dev).manual_seed(8)),
        results256["bf16"])


    phase("19 FIR gradients against autograd through the plain versions (first and second order)")
    grad_cases = ([("down2x", s) for s in D_LARGE_DOWN + D_SMALL_DOWN + DOWN_SHAPES]
                  + [("down2x", (TRAIN_BATCH_256,) + s[1:]) for s in DOWN_SHAPES_256]
                  + [("up2x", s) for s in UP_SHAPES]
                  + [("up2x", (TRAIN_BATCH_256,) + s[1:]) for s in UP_SHAPES_256]
                  # odd sides: a down2x output of 3 x 5 (its VJP an odd-sided up2x)
                  + [("down2x", (2, 3, 6, 10)), ("up2x", (1, 2, 5, 7))])
    check_fir_grads(fir2x, grad_cases, max_abs)

    phase("20 pair_conv3x3 VJP against autograd through its plain version, batch 4")
    pair_train_shapes = [(TRAIN_BATCH_256, c, s_, s_) for (c, s_) in PAIR_CONVS]
    max_abs["pair_conv3x3.dx"] = check_pair_vjp(pair_conv, pair_train_shapes)
    x = torch.zeros((1, 64, 128, 128), device=dev, dtype=torch.bfloat16)
    try:
        pair_conv.pair_conv3x3(x.float().requires_grad_(), torch.zeros((64, 64, 3, 3), device=dev),
                               torch.zeros((64,), device=dev))
    except ValueError:
        print("an ungated input that needs a gradient still raises ValueError")
    else:
        raise AssertionError("pair_conv3x3 took an f32 input")

    phase("21 CelebA-HQ 256 G and DiscriminatorLarge, full width")
    from ddgan_torch.models import build_discriminator

    tcfg = cfg2.replace(dropout=0.0)
    tcfg32 = tcfg.replace(compute_dtype="float32")
    # N(0,1)/sqrt(fan_in) weights for the GPU-vs-CPU check (the recipe's
    # init gives G an output of ~0, which would make it vacuous), and the
    # recipe's own init, drawn from seeds, for the runs that train
    g_sd = randomize_parameters_(NCSNpp.from_config(tcfg32), seed=11).state_dict()
    d_sd = randomize_parameters_(build_discriminator(tcfg32), seed=12).state_dict()
    gi_sd = NCSNpp.from_config(tcfg32, generator=torch.Generator().manual_seed(11)).state_dict()
    di_sd = build_discriminator(tcfg32, generator=torch.Generator().manual_seed(12)).state_dict()
    n_g_params = sum(v.numel() for v in g_sd.values())
    n_d_params = sum(v.numel() for v in d_sd.values())
    print(f"G {n_g_params} parameters, DiscriminatorLarge {n_d_params} parameters")

    phase("22 one 256² train step (D and G update, R1) in f32: GPU (TF32 off) against the CPU, batch 2")
    step_cmp256 = compare_step_gpu_cpu(tcfg32, g_sd, d_sd, batch=2, seed=13)

    phase("23 the CelebA-HQ 256 recipe in bf16 at batch 4 from its init: 11 steps, launches by "
          "role, f32 trajectory")
    real256 = real_batch(tcfg, TRAIN_BATCH_256, 14).to(dev)
    # At the recipe's lr the first Adam step moves D's output by tens and
    # the bf16 and f32 runs separate after step 0 (phase 23b shows why); the
    # bf16-vs-f32 trajectory is held at lr 1e-7, where what differs is the
    # arithmetic of each step.
    traj = {}
    train_paths = {}
    runs = (("recipe_bf16", "bfloat16", TRAIN_STEPS_256, None),
            ("small_lr_bf16", "bfloat16", 6, TRAJ_LR), ("small_lr_f32", "float32", 6, TRAJ_LR))
    for run, dt_name, n_steps, lr in runs:
        st, stp = build_trainer(tcfg, gi_sd, di_sd, dev, dt_name)
        rng = torch.Generator(device=dev).manual_seed(15)
        losses = []
        for i in range(n_steps):
            reset_counts()
            m = stp(st, real256, rng, lr or tcfg.lr_g, lr or tcfg.lr_d)
            torch.cuda.synchronize()
            vals = [float(v) for v in m]
            check(all(np.isfinite(vals)), f"{run} step {i}: {vals}")
            losses.append((vals[0], vals[3]))
            if run == "recipe_bf16":
                r1 = i % tcfg.lazy_reg == 0
                check(r1 == (vals[4] > 0), f"step {i}: penalty {vals[4]}")
                want = expected_fir_calls(6, len(tcfg.ch_mult) - 1, r1, shared=True)
                calls = {k: dict(v) for k, v in fir2x.CALLS.items()}
                check(calls == want, f"step {i} FIR calls {calls}, expected {want}")
                check(fir2x.LAUNCHES == {k: sum(v.values()) for k, v in want.items()},
                      f"step {i}: FIR launches {fir2x.LAUNCHES}")
                check(pair_conv.CALLS == {"forward": 46, "dx": 18, "dx_library": 5}
                      and pair_conv.LAUNCHES["pair_conv3x3"] == 64,
                      f"step {i}: pair_conv3x3 {pair_conv.CALLS} {pair_conv.LAUNCHES}")
                if i in (0, 1):
                    train_paths["celeba256_train_" + ("r1" if r1 else "plain")] = {
                        "fir": calls, "pair_conv3x3": dict(pair_conv.CALLS)}
        finite = all(bool(torch.isfinite(p_).all()) for m_ in (st.gen, st.disc)
                     for p_ in m_.parameters())
        check(finite, f"{run}: parameters not finite")
        traj[run] = losses
        print(f"{run} losses (errD, errG): {[(round(a, 5), round(b, 5)) for a, b in losses]}")
        if run == "recipe_bf16":
            train256 = (st, stp)
        else:
            del st, stp
    traj_diff = float(np.abs(np.asarray(traj["small_lr_bf16"])
                             - np.asarray(traj["small_lr_f32"])).max())
    print(f"bf16 vs f32 over 6 steps at lr {TRAJ_LR}: max |Δloss| {traj_diff:.4g}; launches "
          f"per step {json.dumps(train_paths)}")
    check(traj_diff < 5e-2, f"bf16 trajectory left f32: {traj_diff}")

    phase("23b the recipe's step 0 at its lr: bf16 with the kernels and with their plain "
          "versions, f32, and D's gradient swapped between them")
    attribution = first_step_attribution(tcfg, gi_sd, di_sd, real256, fir2x, pair_conv)

    phase("24 the flagship train step: f32 GPU vs CPU at batch 4, then bf16 at batch 64 from "
          "its init")
    fcfg = cfg.replace(dropout=0.0)
    fcfg32 = fcfg.replace(compute_dtype="float32")
    fg_sd = randomize_parameters_(NCSNpp.from_config(fcfg32), seed=16).state_dict()
    fd_sd = randomize_parameters_(build_discriminator(fcfg32), seed=17).state_dict()
    print(f"flagship G {sum(v.numel() for v in fg_sd.values())} parameters, "
          f"DiscriminatorSmall {sum(v.numel() for v in fd_sd.values())} parameters")
    step_cmp32 = compare_step_gpu_cpu(fcfg32, fg_sd, fd_sd, batch=4, seed=18)
    fgi_sd = NCSNpp.from_config(fcfg32, generator=torch.Generator().manual_seed(16)).state_dict()
    fdi_sd = build_discriminator(fcfg32, generator=torch.Generator().manual_seed(17)).state_dict()
    fst, fstep = build_trainer(cfg, fgi_sd, fdi_sd, dev, "bfloat16")  # the recipe: dropout 0.1
    freal = real_batch(cfg, TRAIN_BATCH, 19).to(dev)
    frng = torch.Generator(device=dev).manual_seed(20)
    for i in range(3):
        reset_counts()
        m = fstep(fst, freal, frng, cfg.lr_g, cfg.lr_d)
        torch.cuda.synchronize()
        vals = [float(v) for v in m]
        r1 = i % cfg.lazy_reg == 0
        want = expected_fir_calls(3, len(cfg.ch_mult) - 1, r1, shared=False)
        calls = {k: dict(v) for k, v in fir2x.CALLS.items()}
        check(all(np.isfinite(vals)) and r1 == (vals[4] > 0), f"flagship step {i}: {vals}")
        check(calls == want and fir2x.LAUNCHES == {k: sum(v.values()) for k, v in want.items()},
              f"flagship step {i}: FIR calls {calls}, expected {want}")
        check(pair_conv.LAUNCHES["pair_conv3x3"] == 0, "flagship step launched pair_conv3x3")
        if i in (0, 1):
            train_paths["flagship_train_" + ("r1" if r1 else "plain")] = {
                "fir": calls, "pair_conv3x3": dict(pair_conv.CALLS)}
        print(f"flagship bf16 step {i}: errD {vals[0]:.4f} errG {vals[3]:.4f} "
              f"penalty {vals[4]:.3g}; FIR {calls}")
    check(all(bool(torch.isfinite(p_).all()) for p_ in fst.gen.parameters()), "flagship params")

    phase("25 train-step timing (bf16) and each kernel's time by role")
    st, stp = train256
    train_times = {
        "celeba256": {**time_steps(st, stp, real256, torch.Generator(device=dev).manual_seed(21),
                                   n=4), "batch": TRAIN_BATCH_256},
        "flagship": {**time_steps(fst, fstep, freal, torch.Generator(device=dev).manual_seed(22),
                                  n=4), "batch": TRAIN_BATCH},
    }
    for model, t_ in train_times.items():
        for label in ("r1_step", "plain_step"):
            t_[label.replace("step", "samples_per_s")] = t_["batch"] / t_[label] * 1e3
        print(f"{model} bf16 train step: R1 {t_['r1_step']:.3f} ms, other "
              f"{t_['plain_step']:.3f} ms ({t_['plain_samples_per_s']:.2f} samples/s at batch "
              f"{t_['batch']}); peak memory {t_['peak_memory_gb']:.2f} GB")
    recorded = {}
    for model, (s_, f_, x_) in (("celeba256", (st, stp, real256)), ("flagship", (fst, fstep, freal))):
        for label, counter in (("r1", 0), ("plain", 1)):
            s_.step = counter
            with LaunchRecorder(fir2x, pair_conv) as rec:
                f_(s_, x_, torch.Generator(device=dev).manual_seed(23), 1e-4, 1e-4)
            torch.cuda.synchronize()
            recorded[f"{model}_{label}"] = rec.counts()
    role_times = time_launches(fir2x, pair_conv, recorded)
    for key, per_step in sorted(role_times.items()):
        for step_name, r in per_step.items():
            print(f"{key} {step_name}: {r['launches']} launches, {r['ms']:.4f} ms per step, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']}), plain {r['plain_ms']:.4f}, "
                  f"library {r['library_ms']:.4f}")

    phase("26 where the 256² train step's time goes (torch.profiler, bf16, two steps)")
    st.step = 9  # a warm-up step, then an R1 step (10) and another (11) under the profiler
    train_profile = profile_steps(
        lambda: stp(st, real256, torch.Generator(device=dev).manual_seed(24), 1e-4, 1e-4),
        (train_times["celeba256"]["r1_step"] + train_times["celeba256"]["plain_step"]) / 2,
        fir2x, pair_conv)
    print(f"{train_profile['kernel_launches_per_step']} kernel launches per 256² step "
          f"(mean of an R1 step and another)")

    phase("27 result")
    main_paths = {"flagship_cli": main_launches, "celeba256_cli": main256_launches}
    train_forward = {path: {**{k: v["forward"] for k, v in c["fir"].items()},
                            "pair_conv3x3": c["pair_conv3x3"]["forward"]}
                     for path, c in train_paths.items()}
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
        by_path = {**{k: p_[name] for k, p_ in main_paths.items()},
                   **{k: p_[name] for k, p_ in train_forward.items()}}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_abs[name],
            **total,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            "shapes": rows,
        })
    # the backward roles: times per CelebA-HQ 256 bf16 R1 step (the other
    # steps in "per_step"); launches over the four driven train steps
    role_err = {"up2x.backward": max_abs["down2x.grad"], "down2x.backward": max_abs["up2x.grad"],
                "down2x.second_order": max(max_abs["down2x.grad"], max_abs["up2x.grad"]),
                "pair_conv3x3.dx": max_abs["pair_conv3x3.dx"]}
    for key in ("up2x.backward", "down2x.backward", "down2x.second_order", "pair_conv3x3.dx"):
        kernel, role = key.split(".")
        by_path = {}
        for path, c in train_paths.items():
            by_path[path] = (c["pair_conv3x3"]["dx"] if kernel == "pair_conv3x3"
                             else c["fir"][kernel][role])
        r = role_times[key]["celeba256_r1"]
        entries.append({
            "name": key,
            "route": "cuda",
            "source": SOURCES[kernel],
            "replaces": REPLACES_BWD[key],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": role_err[key],
            **{f: r[f] for f in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by")},
            "per_step": role_times[key],
        })
    print(json.dumps({
        "flagship": {"sampler_ms": results, "batch": BATCH, "steps": T,
                     "samples_per_s": {k: BATCH / v * 1e3 for k, v in results.items()},
                     "gpu_vs_cpu_max_abs": sampler_err, "profile": profile},
        "celeba256": {"sampler_ms": results256, "batch": BATCH_256, "steps": T_256,
                      "samples_per_s": {k: BATCH_256 / v * 1e3 for k, v in results256.items()},
                      "parameters": n_params2, "gpu_vs_cpu_max_abs": err256,
                      "bf16_vs_f32_max_abs": bf16_err, "profile": profile256},
        "train": {"times": train_times, "launches_by_step": train_paths,
                  "gpu_vs_cpu_step": {"celeba256": step_cmp256, "flagship": step_cmp32},
                  "bf16_vs_f32_max_abs_dloss": traj_diff, "first_step_attribution": attribution,
                  "trajectories": traj, "parameters":
                  {"celeba256_G": n_g_params, "celeba256_D": n_d_params},
                  "roles": role_times, "profile": train_profile},
        "build_s": build_s,
        "phase_s": PHASE_S,
    }))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

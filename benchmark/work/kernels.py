"""The FIR resamples (K1's work) and gated 3x3 convs (K2's work) that a step
or a sampler call needs, from the shapes the plain reference runs at, and
the least time the card could take for them.

`WorkRecorder` is told of every 2x FIR resample (pattern, input shape,
order of differentiation: 0 forward, 1 the VJP of a forward, 2 the VJP of
a VJP) and of every 3x3 conv of the generator (input and weight shape, and
whether its input needs a gradient) while the reference runs on the meta
device (`benchmark/reference/ops.py`).

The bounds are copies of `chip_smoke.py`'s `fir_bound_ms` and
`pair_bound_ms` (in seconds): the larger of the bytes read once and
written once at the HBM rate and the operations at the peak rate (float32
for the FIR, whose kernel computes in float32; bfloat16 for the conv). A
FIR resample's bytes are counted at 2 bytes an element, the bfloat16 that
the configurations compute in. A conv is K2's when it passes the gate of
`ddgan_torch/ops/pair_conv.py:supported` (copied as `gated`), and its input
gradient is K2's when the flipped conv passes it too (C_in 64).
`expected_fir_calls` is a copy of `chip_smoke.py`'s count of FIR calls by
pattern and role, held against the recorder by the tests.
"""

from __future__ import annotations

from .peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S

ROLES = ("forward", "backward", "second_order")
BF16_BYTES = 2


class WorkRecorder:
    def __init__(self):
        self.fir_calls: list[tuple[str, tuple, int]] = []
        self.conv_calls: list[tuple[tuple, tuple, bool]] = []

    def fir(self, name: str, shape: tuple, order: int) -> None:
        self.fir_calls.append((name, shape, order))

    def conv3x3(self, x_shape: tuple, w_shape: tuple, needs_dx: bool) -> None:
        self.conv_calls.append((x_shape, w_shape, needs_dx))

    def fir_roles(self) -> dict:
        """Calls by pattern and role, as `expected_fir_calls` counts them."""
        out = {name: dict.fromkeys(ROLES, 0) for name in ("down2x", "up2x")}
        for name, _, order in self.fir_calls:
            out[name][ROLES[min(order, 2)]] += 1
        return out

    def pair_conv_roles(self, bf16: bool) -> dict:
        """K2's calls by role: gated forwards, and input gradients that
        pass the gate ("dx") or go to the library ("dx_library")."""
        out = {"forward": 0, "dx": 0, "dx_library": 0}
        for x_shape, w_shape, needs_dx in self.conv_calls:
            if not (bf16 and gated(x_shape, w_shape)):
                continue
            out["forward"] += 1
            if needs_dx:
                out["dx" if gated(*_dx_shapes(x_shape, w_shape)) else "dx_library"] += 1
        return out

    def fir_bound_s(self) -> float:
        return sum(fir_bound_s(name, shape) for name, shape, _ in self.fir_calls)

    def pair_conv_bound_s(self, bf16: bool) -> float:
        """Bound of the gated convs' forwards and of their K2 input
        gradients; 0 unless the configuration computes in bfloat16."""
        if not bf16:
            return 0.0
        total = 0.0
        for x_shape, w_shape, needs_dx in self.conv_calls:
            if not gated(x_shape, w_shape):
                continue
            total += pair_bound_s(x_shape)
            dx_x, dx_w = _dx_shapes(x_shape, w_shape)
            if needs_dx and gated(dx_x, dx_w):
                total += pair_bound_s(dx_x)
        return total


def _dx_shapes(x_shape, w_shape):
    """The input and weight shapes of a conv's input gradient: the output's
    gradient through the flipped, transposed weight."""
    n, c, h, w = x_shape
    return (n, w_shape[0], h, w), (c, w_shape[0], 3, 3)


def gated(x_shape, w_shape) -> bool:
    """The gate of K2 for a bfloat16 conv: 3x3, C_out 64, even C_in <= 128,
    square maps of side >= 128 and a multiple of 32."""
    _, c, h, w = x_shape
    co, ci, kh, kw = w_shape
    return ((kh, kw) == (3, 3) and ci == c and co == 64 and c % 2 == 0 and c <= 128
            and h == w and h >= 128 and h % 32 == 0)


def fir_bound_s(kind: str, shape) -> float:
    n, c, h, w = shape
    planes = n * c
    if kind == "down2x":
        out = h * w // 4
        flops = planes * (h * (w // 2) * 8 + out * 8)  # 4 taps a pass
    else:
        out = 4 * h * w
        flops = planes * (h * 2 * w * 4 + out * 4)  # 2 taps a pass
    return max(planes * (h * w + out) * BF16_BYTES / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def pair_bound_s(shape) -> float:
    """x and w (bf16) and b (f32) read once, y (bf16, 64 channels) written
    once; 2*64*9*C_in flops an output pixel at the bf16 peak."""
    n, c, h, w = shape
    t_bytes = (n * c * h * w * 2 + 64 * c * 9 * 2 + 64 * 4 + n * 64 * h * w * 2) / HBM_BYTES_PER_S
    return max(t_bytes, 2 * n * h * w * 64 * 9 * c / BF16_FLOPS)


def expected_fir_calls(n_d: int, n_g: int, r1: bool, shared: bool, *,
                       g_resample: int = 2) -> dict:
    """FIR calls of one train step by pattern and role, for a discriminator
    with `n_d` downsampling blocks and a generator with `n_g` transitions
    each way, BigGAN resblocks resampling h and the skip (`g_resample` 2),
    no pyramid FIR, no remat. D runs twice a block per forward, on the
    fakes and x_t in the D update (and x_t again for an R1 that is not
    shared) and on the G update's fakes; every D forward is differentiated
    once, an R1 step differentiates D(x_t) a second time, whose backward is
    the second order. G runs twice and is differentiated once."""
    per_d = 2 * n_d
    d_fwd = 3 + int(r1 and not shared)
    d_bwd = d_fwd + int(r1)
    g = n_g * g_resample
    return {
        "down2x": {"forward": d_fwd * per_d + 2 * g, "backward": g,
                   "second_order": per_d if r1 else 0},
        "up2x": {"forward": 2 * g, "backward": d_bwd * per_d + g, "second_order": 0},
    }

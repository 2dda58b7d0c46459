"""The port's gated 3x3 conv (`ddgan_torch.ops.pair_conv`) against the JAX
package's Pallas kernel `pair_conv3x3` (interpret mode on the CPU), its
gate `supported`, its VJP, and the routing of `Conv3x3`.

Inputs come from numpy seeds; images cross NHWC (JAX) <-> NCHW (port),
weights HWIO <-> OIHW. Both sides round x and w to bf16, sum in f32 and
add the f32 bias before one rounding to bf16, so they differ by at most
one bf16 rounding step: max-abs <= 1 ulp of max|ref|. The VJP is held to
`jax.grad` through the JAX `pair_conv3x3` under the bounds of
`tests/test_pallas_conv.py::test_pair_conv_vjp_matches_lax`: dx and dW
within 5e-2 of max|ref| (bf16 operands, sums in another order), db within
5e-2 of the float64 ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.nn.layers import Conv3x3 as JConv3x3
from ddgan_tpu.ops.experimental import pallas_conv

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.nn.layers import Conv3x3
from ddgan_torch.ops import pair_conv

from _torch_port import count_pallas_calls, count_routed, nchw, nhwc


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _inputs(c_in, n=2, s=128, seed=0):
    """As `tests/test_pallas_conv.py::_mk`: x bf16 NHWC, w HWIO f32, b f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, s, s, c_in).astype(np.float32)
    w = (rng.randn(3, 3, c_in, 64) * 0.1).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("c_in", [64, 128])
def test_ref_matches_the_pallas_kernel(c_in):
    x, w, b = _inputs(c_in)
    want = np.asarray(
        pallas_conv.pair_conv3x3(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b)),
        np.float32,
    )
    xt = nchw(x).to(torch.bfloat16)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = pair_conv.pair_conv3x3_ref(xt, wt, torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64, 128, 128)
    scale = float(np.abs(want).max())
    assert scale > 1.0
    assert float(np.abs(nhwc(got) - want).max()) <= _bf16_ulp(scale)
    # on a CPU tensor the wrapper is the plain version
    with torch.no_grad():
        assert torch.equal(pair_conv.pair_conv3x3(xt, wt, torch.from_numpy(b)), got)


# (x NHWC, w HWIO, dtype) -> one clause of the gate each
_GATE_CASES = {
    "ok_64_128": ((2, 128, 128, 64), (3, 3, 64, 64), "bfloat16"),
    "ok_128_256": ((2, 256, 256, 128), (3, 3, 128, 64), "bfloat16"),
    "ok_2_160": ((1, 160, 160, 2), (3, 3, 2, 64), "bfloat16"),
    "kernel_1x1": ((2, 128, 128, 64), (1, 1, 64, 64), "bfloat16"),
    "kernel_3x1": ((2, 128, 128, 64), (3, 1, 64, 64), "bfloat16"),
    "c_in_mismatch": ((2, 128, 128, 64), (3, 3, 32, 64), "bfloat16"),
    "c_out_128": ((2, 128, 128, 64), (3, 3, 64, 128), "bfloat16"),
    "c_out_32": ((2, 128, 128, 64), (3, 3, 64, 32), "bfloat16"),
    "c_in_odd": ((2, 128, 128, 63), (3, 3, 63, 64), "bfloat16"),
    "c_in_192": ((2, 128, 128, 192), (3, 3, 192, 64), "bfloat16"),
    "h_ne_w": ((2, 128, 160, 64), (3, 3, 64, 64), "bfloat16"),
    "side_96": ((2, 96, 96, 64), (3, 3, 64, 64), "bfloat16"),
    "side_136": ((2, 136, 136, 64), (3, 3, 64, 64), "bfloat16"),
    "float32": ((2, 128, 128, 64), (3, 3, 64, 64), "float32"),
    "float16": ((2, 128, 128, 64), (3, 3, 64, 64), "float16"),
    "x_3d": ((128, 128, 64), (3, 3, 64, 64), "bfloat16"),
    "w_3d": ((2, 128, 128, 64), (3, 64, 64), "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_GATE_CASES))
def test_supported_is_the_jax_gate(case):
    x_shape, w_shape, dtype = _GATE_CASES[case]
    theirs = pallas_conv.supported(x_shape, w_shape, jnp.dtype(dtype))
    x_nchw = (x_shape[0], x_shape[3], x_shape[1], x_shape[2]) if len(x_shape) == 4 else x_shape
    w_oihw = (w_shape[3], w_shape[2], w_shape[0], w_shape[1]) if len(w_shape) == 4 else w_shape
    ours = pair_conv.supported(x_nchw, w_oihw, getattr(torch, dtype))
    assert ours == theirs
    assert theirs == case.startswith("ok")


# (C_in, C_out, side, Conv3x3 keyword arguments) -> routed or not
_ROUTE_CASES = {
    "gated_64_128": (64, 64, 128, {}),
    "gated_128_256": (128, 64, 256, {}),
    "f32": (64, 64, 128, {"dtype": None}),
    "c_out_32": (64, 32, 128, {}),
    "c_in_192": (192, 64, 128, {}),
    "side_64": (64, 64, 64, {}),
    "stride_2": (64, 64, 128, {"stride": 2}),
    "padding_0": (64, 64, 128, {"padding": 0}),
    "dilation_2": (64, 64, 128, {"dilation": 2}),
    "no_bias": (64, 64, 128, {"use_bias": False}),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_conv3x3_routes_exactly_the_gated_convs(case, monkeypatch):
    c_in, c_out, side, kw = _ROUTE_CASES[case]
    kw = {"dtype": "bf16", **kw}
    monkeypatch.setenv("DDGAN_TPU_PALLAS_CONV", "1")
    jmod = JConv3x3(c_out, **{**kw, "dtype": jnp.bfloat16 if kw["dtype"] else None})
    x_abs = jax.ShapeDtypeStruct((1, side, side, c_in), jnp.float32)
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x_abs)
    jaxpr = jax.make_jaxpr(jmod.apply)(params, x_abs)
    jax_routed = count_pallas_calls(jaxpr.jaxpr)

    calls = count_routed(monkeypatch)
    conv = Conv3x3(c_in, c_out, **{**kw, "dtype": torch.bfloat16 if kw["dtype"] else None})
    with torch.no_grad():
        conv(torch.zeros(1, c_in, side, side))
    assert len(calls) == jax_routed == int(case.startswith("gated"))
    # the parameters are the plain conv's, named as the JAX package exports them
    sd = conv.state_dict()
    theirs = state_dict_from_flax(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                               params["params"]))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}
    assert tuple(sd["weight"].shape) == (c_out, c_in, 3, 3)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, w, b = _inputs(64, n=1)
    xt, wt, bt = nchw(x).to(torch.bfloat16), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), \
        torch.from_numpy(b)
    before = dict(pair_conv.LAUNCHES)
    # inputs that need a gradient are taken: the VJP is ported
    assert pair_conv.pair_conv3x3(xt, wt.clone().requires_grad_(), bt).requires_grad
    assert pair_conv.pair_conv3x3(xt.clone().requires_grad_(), wt, bt).requires_grad
    bad = [
        (xt.float(), wt, bt),                        # f32 input
        (xt[:, :, :96, :96].contiguous(), wt, bt),   # 96 < 128
        (xt, torch.cat([wt, wt]), bt),               # C_out 128
        (xt, wt, torch.cat([bt, bt])),               # bias of 128
        (xt.transpose(2, 3), wt, bt),                # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pair_conv.pair_conv3x3(*args)
    assert pair_conv.LAUNCHES == before


@pytest.mark.parametrize("c_in", [64, 128])
def test_vjp_matches_jax(c_in):
    """dx, dW and db against `jax.grad` through the JAX `pair_conv3x3` at
    (1, 128, 128, C_in) in bf16. dx takes this kernel's route only when the
    flipped, in/out-swapped weights pass the gate (C_in 64); otherwise the
    library conv, as the JAX `_bwd`."""
    x, w, b = _inputs(c_in, n=1, seed=3)

    def loss(x_, w_, b_):
        return jnp.sum(pallas_conv.pair_conv3x3(x_, w_, b_).astype(jnp.float32) ** 2)

    jx = jnp.asarray(x, jnp.bfloat16)
    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(w), jnp.asarray(b))

    xt = nchw(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    pair_conv.reset_launch_counts()
    y = pair_conv.pair_conv3x3(xt, wt, bt)
    (y.float() ** 2).sum().backward()
    gated = pair_conv.supported((1, 64, 128, 128), (c_in, 64, 3, 3), torch.bfloat16)
    assert gated == (c_in == 64)
    assert pair_conv.CALLS == {"forward": 1, "dx": int(gated), "dx_library": int(not gated)}
    assert pair_conv.LAUNCHES == {"pair_conv3x3": 0}  # CPU tensors take the plain path
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == bt.grad.dtype == torch.float32

    for got, want, name in ((nhwc(xt.grad), gx, "dx"),
                            (wt.grad.numpy().transpose(2, 3, 1, 0), gw, "dw")):
        want = np.asarray(want, np.float32)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 5e-2, (name, err)
    y64 = np.asarray(pallas_conv._ref_conv(jx, jnp.asarray(w).astype(jx.dtype),
                                           jnp.asarray(b)), np.float64)
    db_true = 2.0 * y64.sum(axis=(0, 1, 2))
    for db in (bt.grad.numpy(), np.asarray(gb)):
        assert np.abs(db - db_true).max() / np.abs(db_true).max() < 5e-2


@pytest.mark.parametrize("c_in", [2, 34, 64, 96, 128])
@pytest.mark.parametrize("side", [128, 160, 224, 256])
def test_launch_plan_fits_and_covers(c_in, side):
    """The kernel's launch plan over the gate's domain: the packed weights
    and at least two ring stages fit in a block's 227 KB, the grid is one
    block per SM at most, and the 4 x 64 output tiles cover the output
    exactly once (the last column tile of 160 and 224 is half outside and
    masked)."""
    for n, sms in ((1, 132), (4, 132), (16, 132), (3, 8)):
        plan = pair_conv.launch_plan((n, c_in, side, side), sms)
        assert plan["stages"] >= 2 and plan["smem_bytes"] <= pair_conv._SMEM_LIMIT
        assert plan["smem_bytes"] >= 1024 + 9 * -(-c_in // 64) * 8192 + plan["stages"] * 39936
        assert plan["stages"] == (3 if c_in <= 64 else 2)
        assert plan["grid"] == min(plan["tiles"], sms)
        hits = np.zeros((n, side, -(-side // 64) * 64), np.int64)
        col_tiles = -(-side // 64)
        for t in range(plan["tiles"]):
            x0, rest = (t % col_tiles) * 64, t // col_tiles
            y0, b = (rest % (side // 4)) * 4, rest // (side // 4)
            hits[b, y0:y0 + 4, x0:x0 + 64] += 1
        assert (hits == 1).all()
    # the smallest gated case of a train step fills the 132 SMs of an H100
    assert pair_conv.launch_plan((4, 128, 128, 128), 132)["tiles"] >= 132


def test_flip_route_and_its_double_backward_on_cpu():
    """The dx route passes the forward weight with `flip` (the kernel flips
    and swaps it while packing): the Function's output and its own VJP
    (dx of dx, and dW through the flip) against autograd through plain
    PyTorch on the explicitly flipped weight, in float64 bounds of bf16."""
    rs = np.random.RandomState(11)
    g = torch.from_numpy(rs.randn(1, 64, 128, 128).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rs.randn(64, 64, 3, 3) / 24).astype(np.float32))
    r = torch.from_numpy(rs.randn(1, 64, 128, 128).astype(np.float32))
    gi, wi = g.clone().requires_grad_(True), w.clone().requires_grad_(True)
    pair_conv.reset_launch_counts()
    dx = pair_conv._apply(gi, wi, None, "dx", True)
    want = pair_conv.pair_conv3x3_ref(g, pair_conv.flipped(w).contiguous(), torch.zeros(64))
    assert torch.equal(dx, want)
    (dx.float() * r).sum().backward()
    assert pair_conv.CALLS == {"forward": 0, "dx": 2, "dx_library": 0}
    gp, wp = g.float().requires_grad_(True), w.clone().requires_grad_(True)
    y = torch.nn.functional.conv2d(gp, wp.flip(2, 3).transpose(0, 1), padding=1)
    (y * r).sum().backward()
    for got, ref in ((gi.grad.float(), gp.grad), (wi.grad, wp.grad)):
        assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()

"""The port's flax msgpack reader (`ddgan_torch.compat.msgpack.read_msgpack`)
against `flax.serialization.msgpack_restore`, on files the JAX package
writes (`save_netg` of the tiny flagship generator, `save_content` of a
train state with optax moments and int scalars), on trees with bf16, int,
bool and complex leaves, on trees chunked by `msgpack_serialize`, and on
every msgpack type against `msgpack.unpackb`; and `load_netg_ckpt` into the
port's generator with `strict=True`.
"""

import numpy as np
import pytest
import torch

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack

from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train import checkpoint as jckpt
from ddgan_tpu.train.optim import make_optimizer
from ddgan_tpu.train.state import TrainState

from ddgan_torch.compat import load_netg_ckpt, read_msgpack
from ddgan_torch.models import NCSNpp
from ddgan_torch.utils import randomize_parameters_

from _torch_port import flax_params_from_port, one_torch_thread, tiny_config  # noqa: F401


def assert_same_tree(got, want, path="") -> None:
    """Equal structure, types and values; a bf16 leaf (a torch tensor in the
    port, an ml_dtypes array in flax) is compared bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif getattr(want, "dtype", None) is not None and want.dtype.name == "bfloat16":
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope="module")
def tiny_flax():
    """(cfg, port generator with non-trivial weights, its flax params)."""
    cfg = tiny_config()
    net = randomize_parameters_(NCSNpp.from_config(cfg), 0).eval()
    gen = JNCSNpp.from_config(cfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: gen.init(
        {"params": k, "dropout": k},
        jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz))))
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    return cfg, net, flax_params_from_port(net, template)


def test_netg_ckpt_reads_as_flax_does_and_loads_strict(tmp_path, tiny_flax):
    cfg, net, params = tiny_flax
    jckpt.save_netg(tmp_path, 3, params)
    data = (tmp_path / "netG_3.ckpt").read_bytes()
    got = read_msgpack(data)
    assert_same_tree(got, fser.msgpack_restore(data))
    assert list(got) == ["params"]

    sd = load_netg_ckpt(str(tmp_path / "netG_3.ckpt"))
    other = NCSNpp.from_config(cfg)
    other.load_state_dict(sd, strict=True)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_content_ckpt_reads_as_flax_does(tmp_path, tiny_flax):
    """A train state with the optimizer's nested chain state (clip, Adam's
    count, mu and nu) and int32 step and epoch scalars."""
    _, _, params = tiny_flax
    tx = make_optimizer(0.5, 0.9)
    d_params = {"conv": {"kernel": jnp.ones((3, 3, 3, 4)), "bias": jnp.zeros((4,))}}
    state = TrainState(
        params_G=params, params_D=d_params, buffers_G={},
        opt_G=tx.init(params), opt_D=tx.init(d_params),
        ema_G=jax.tree.map(lambda a: a * 0.5, params),
        step=jnp.asarray(17, jnp.int32), epoch=jnp.asarray(4, jnp.int32))
    jckpt.save_content(tmp_path, state, {"dataset": "synthetic", "seed": 1})
    data = (tmp_path / "content.ckpt").read_bytes()
    got = read_msgpack(data)
    assert_same_tree(got, fser.msgpack_restore(data))
    assert got["step"] == 17 and got["step"].dtype == np.int32
    assert got["opt_G"]["1"]["count"].dtype == np.int32  # scale_by_adam's count


def test_bf16_int_bool_complex_leaves_read_as_flax_does():
    tree = {
        "bf16": jnp.arange(7, dtype=jnp.bfloat16) / 3,
        "bf16_scalar": np.asarray(jnp.asarray(1.5, jnp.bfloat16))[()],
        "f16": np.linspace(-2, 2, 5, dtype=np.float16),
        "i8": np.arange(-3, 3, dtype=np.int8), "u64": np.asarray([2**63 + 5], np.uint64),
        "bool": np.asarray([True, False, True]), "bool_scalar": np.bool_(False),
        "c64": np.asarray([1 + 2j, -3j], np.complex64), "c_scalar": np.complex128(2 - 1j),
        "py": {"int": -2**40, "small": 7, "float": 0.25, "bool": True, "complex": 1.5 - 2j,
               "none": None, "str": "é" * 40, "bytes": b"\x00\xff" * 200},
        "empty": np.zeros((0, 3), np.float32), "scalar": np.float64(3.25),
    }
    data = fser.msgpack_serialize(tree)
    got = read_msgpack(data)
    assert_same_tree(got, fser.msgpack_restore(data))
    assert got["bf16_scalar"].shape == () and got["bf16_scalar"].item() == 1.5


def test_chunked_leaves_read_as_flax_does(monkeypatch):
    """Leaves over MAX_CHUNK_SIZE bytes (patched small here) are split into
    `__msgpack_chunked_array__` dicts on writing and joined on reading."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(0)
    tree = {"big": rs.randn(7, 11).astype(np.float32), "bf16": jnp.ones((70,), jnp.bfloat16),
            "nested": {"w": rs.randint(0, 9, (3, 50)).astype(np.int64)},
            "small": np.arange(3, dtype=np.float32)}
    data = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = read_msgpack(data)
    assert_same_tree(got, fser.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])
    chunked_top = fser.msgpack_serialize(rs.randn(40).astype(np.float32))
    np.testing.assert_array_equal(read_msgpack(chunked_top), fser.msgpack_restore(chunked_top))


def test_every_msgpack_type_reads_as_msgpack_does():
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    obj = {
        "ints": ints, "nil": None, "t": True, "f": False, "f64": 0.1,
        "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "arrays": [list(range(15)), list(range(16)), list(range(65536))],
        "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                 {str(i): None for i in range(65536)}],
    }
    for single_float in (False, True):
        data = msgpack.packb(obj, use_bin_type=True, use_single_float=single_float)
        assert_same_tree(read_msgpack(data), msgpack.unpackb(data, raw=False))
    # fixext 4 and 8 and ext 8, 16 and 32, through flax's complex (code 2)
    # and ndarray (code 1) payloads of those sizes
    for parts in ((1, 200), (-100, 2**20)):
        data = msgpack.packb(msgpack.ExtType(2, msgpack.packb(parts)))
        assert data[0] == {4: 0xD6, 8: 0xD7}[len(msgpack.packb(parts))]
        assert read_msgpack(data) == complex(*parts) == fser.msgpack_restore(data)
    for n in (4, 1000, 20000):
        data = fser.msgpack_serialize({"a": np.arange(n, dtype=np.float32)})
        np.testing.assert_array_equal(read_msgpack(data)["a"], np.arange(n, dtype=np.float32))


@pytest.mark.parametrize("case", ["truncated", "trailing", "ext_code", "fixext_code", "marker"])
def test_malformed_input_raises(case):
    good = fser.msgpack_serialize({"w": np.ones(3, np.float32)})
    data = {
        "truncated": good[:-1],
        "trailing": good + b"\x00",
        "ext_code": msgpack.packb(msgpack.ExtType(5, b"abc")),
        "fixext_code": msgpack.packb(msgpack.ExtType(9, b"a")),
        "marker": b"\xc1",
    }[case]
    with pytest.raises(ValueError):
        read_msgpack(data)

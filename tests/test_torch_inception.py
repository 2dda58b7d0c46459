"""The port's FID-InceptionV3 (`ddgan_torch.eval.inception`) against the JAX
package's (`ddgan_tpu.eval.inception`) on the same numpy-seeded inputs.

The random weights must be the JAX package's draw for draw (transposed
HWIO -> OIHW), not merely alike in their statistics; every FID block and the
logits agree within 1e-4 of max|ref| at 128² with the resize off (as
`tests/test_inception_parity.py` holds the JAX network), and the resize to
299 within 1e-5 at sides that grow (16, 32, 256) and one that shrinks (512,
where `jax.image.resize` antialiases). A torch-format checkpoint (the test
oracle's state_dict, which has the real file's keys) loads with
`strict=True`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddgan_tpu.eval import inception as jinc

from ddgan_torch import _device
from ddgan_torch.eval import inception as inc

from _torch_port import nchw, nhwc, one_torch_thread  # noqa: F401
from torch_inception_oracle import seeded_oracle


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _assert_same_weights(ours: dict, theirs: dict) -> None:
    """The port's OIHW weights equal the JAX package's HWIO ones transposed,
    bit for bit, in float32: the JAX package's draws are float64 products
    (under NumPy 2 a float32 array times np.sqrt's float64 scalar), which
    its network takes in as float32."""
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        want = np.asarray(jnp.asarray(v))
        want = want.transpose(3, 2, 0, 1) if k.endswith(".conv.weight") else want
        assert ours[k].dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(ours[k].numpy(), want, err_msg=k)


@pytest.fixture(scope="module")
def weights():
    """(port logits params, JAX logits params), seed 0."""
    return inc.random_fid_inception_logits_params(0), jinc.random_fid_inception_logits_params(0)


def _port_model(params, **kw) -> inc.InceptionV3FID:
    model = inc.InceptionV3FID(**kw)
    model.load_state_dict({k: v for k, v in params.items() if k in model.state_dict()},
                          strict=True)
    return model


def test_all_blocks_match_jax_no_resize(weights):
    ours, theirs = weights
    _assert_same_weights(inc.random_fid_inception_params(0), jinc.random_fid_inception_params(0))
    x = np.random.RandomState(42).rand(2, 128, 128, 3).astype(np.float32)
    jmodel = jinc.InceptionV3FID({k: v for k, v in theirs.items() if not k.startswith("fc.")},
                                 output_blocks=(0, 1, 2, 3), resize_input=False)
    want = [np.asarray(o) for o in jmodel(jnp.asarray(x))]
    model = _port_model(ours, output_blocks=(0, 1, 2, 3), resize_input=False)
    with torch.no_grad():
        got = [nhwc(o) for o in model(nchw(x))]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 30, 30, 64), (2, 13, 13, 192), (2, 6, 6, 768), (2, 1, 1, 2048)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.abs(w).max() > 0.1, f"block {i} is degenerate"
        assert _rel_err(g, w) < 1e-4, f"block {i}: {_rel_err(g, w):.2e}"


def test_logits_head_matches_jax(weights):
    ours, theirs = weights
    _assert_same_weights(ours, theirs)
    x = np.random.RandomState(3).rand(2, 128, 128, 3).astype(np.float32)
    params = dict(theirs)
    fc_w, fc_b = params.pop("fc.weight"), params.pop("fc.bias")
    jmodel = jinc.InceptionV3FID(params, output_blocks=(3,), resize_input=False)
    want = np.asarray(jmodel.pool_features(jnp.asarray(x))) @ fc_w.T + fc_b
    model = _port_model(ours, resize_input=False, num_classes=inc.NUM_CLASSES)
    with torch.no_grad():
        got = model.logits(nchw(x)).numpy()
    assert got.shape == (2, 1008)
    assert _rel_err(got, want) < 1e-4


@pytest.mark.parametrize("side", [16, 32, 256, 512])
def test_resize_and_normalize_match_jax(side):
    x = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32)
    want = 2 * np.asarray(jinc._resize_bilinear_299(jnp.asarray(x))) - 1
    got = 2 * nhwc(inc.resize_bilinear_299(nchw(x))) - 1
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_block0_through_the_shrinking_resize_matches_jax(weights):
    """The whole input protocol (resize from 512, normalize) into block 0."""
    ours, theirs = weights
    x = np.random.RandomState(9).rand(1, 512, 512, 3).astype(np.float32)
    jmodel = jinc.InceptionV3FID({k: v for k, v in theirs.items() if not k.startswith("fc.")},
                                 output_blocks=(0,))
    want = np.asarray(jmodel(jnp.asarray(x))[0])
    with torch.no_grad():
        got = nhwc(_port_model(ours, output_blocks=(0,))(nchw(x))[0])
    assert got.shape == want.shape == (1, 73, 73, 64)
    assert _rel_err(got, want) < 1e-4


def test_torch_checkpoint_loads_strict_and_matches_the_oracle():
    """The oracle's state_dict has the real checkpoint's keys (AuxLogits
    aside) and non-trivial BatchNorm statistics, so eps 1e-3 and the
    running stats are held too."""
    oracle = seeded_oracle(0)
    sd = oracle.state_dict()
    assert any(k.endswith("num_batches_tracked") for k in sd)
    feats = inc.params_from_torch_state_dict(sd)
    assert not any(k.startswith("fc.") or k.endswith("num_batches_tracked") for k in feats)
    inc.InceptionV3FID().load_state_dict(feats, strict=True)
    model = inc.InceptionV3FID(output_blocks=(0, 1, 2, 3), resize_input=False,
                               num_classes=inc.NUM_CLASSES)
    model.load_state_dict(inc.params_from_torch_state_dict(sd, keep_fc=True), strict=True)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 3, 96, 96).astype(np.float32))
    with torch.no_grad():
        got, want = model(x), oracle.feature_blocks(x, resize_input=False)
        logits, want_logits = model.logits(x), oracle.logits(x, resize_input=False)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel_err(g.numpy(), w.numpy()) < 1e-4, f"block {i}"
    assert _rel_err(logits.numpy(), want_logits.numpy()) < 1e-4


def test_weight_sources_and_messages_match_jax(tmp_path, monkeypatch, capsys, weights):
    """Real weights from $DDGAN_TPU_INCEPTION_PATH win over the random seed,
    with the JAX package's note; without either, the error names the
    variable; block-0 features (dims 64) equal the JAX package's."""
    monkeypatch.delenv(inc.RANDOM_WEIGHTS_ENV, raising=False)
    monkeypatch.delenv(inc.DEFAULT_WEIGHTS_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=inc.DEFAULT_WEIGHTS_ENV):
        inc.default_feature_fn(64, device="cpu")
    with pytest.raises(FileNotFoundError, match=inc.DEFAULT_WEIGHTS_ENV):
        inc.default_logits_fn(device="cpu")

    x = np.random.RandomState(1).rand(2, 24, 24, 3).astype(np.float32)
    monkeypatch.setenv(inc.RANDOM_WEIGHTS_ENV, "0")
    got = inc.default_feature_fn(64, device="cpu")(x)
    ours_out = capsys.readouterr().out
    want = jinc.default_feature_fn(64)(x)
    assert ours_out == capsys.readouterr().out and "RANDOM Inception weights" in ours_out
    assert got.shape == (2, 64) and got.dtype == np.float32
    assert _rel_err(got, np.asarray(want)) < 1e-4

    path = tmp_path / "oracle.pth"
    torch.save(seeded_oracle(1).state_dict(), path)
    monkeypatch.setenv(inc.DEFAULT_WEIGHTS_ENV, str(path))
    real = inc.default_feature_fn(64, device="cpu")(x)
    ours_out = capsys.readouterr().out
    want = jinc.default_feature_fn(64)(x)
    assert ours_out == capsys.readouterr().out and "using REAL weights" in ours_out
    assert _rel_err(real, np.asarray(want)) < 1e-4
    assert _rel_err(real, got) > 1e-2  # the real weights were used


def test_feature_fn_turns_tf32_off_and_restores_the_flags(monkeypatch):
    monkeypatch.setenv(inc.RANDOM_WEIGHTS_ENV, "0")
    monkeypatch.delenv(inc.DEFAULT_WEIGHTS_ENV, raising=False)
    seen = []
    fn = inc.default_feature_fn(64, device="cpu")
    real_conv = torch.nn.Conv2d.forward

    def spy(self, x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real_conv(self, x)

    monkeypatch.setattr(torch.nn.Conv2d, "forward", spy)
    for flags in ((True, True), (False, True)):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flags[0])
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", flags[1])
        fn(np.zeros((1, 8, 8, 3), np.float32))
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    assert seen and set(seen) == {(False, False)}


def test_no_gpu_means_no_features_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(_device.ENV_VAR, raising=False)
    monkeypatch.setenv(inc.RANDOM_WEIGHTS_ENV, "0")
    for make in (lambda: inc.default_feature_fn(64), lambda: inc.default_logits_fn(),
                 lambda: inc.default_feature_fn(64, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    monkeypatch.setenv(_device.ENV_VAR, "cpu")
    assert inc.default_feature_fn(64)(np.zeros((1, 8, 8, 3), np.float32)).shape == (1, 64)

"""The port's T=4 sampling path against the JAX package: schedules, the
posterior step, the whole reverse sampler on the tiny flagship-shaped
generator with injected noise, and the sampler CLI on the CPU.

The sampler is compared with the JAX package's generator and
`sample_posterior_with_noise` looped over the same x_init, z's and noises
(atol 1e-4 over 4 generator calls, f32).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ddgan_tpu.compat import save_torch_netg
from ddgan_tpu.diffusion import schedules as jsched
from ddgan_tpu.models import NCSNpp as JNCSNpp

from ddgan_torch.cli import test_cli
from ddgan_torch.diffusion import schedules
from ddgan_torch.models import NCSNpp
from ddgan_torch.utils import encode_png, randomize_parameters_, save_image

from _torch_port import flax_params_from_port, nchw, nhwc, randn, tiny_config

CPU = "cpu"
T = 4


@pytest.mark.parametrize("geometric,beta_min,beta_max", [(False, 0.1, 20.0), (True, 0.01, 0.5)])
def test_schedule_tables_match_jax(geometric, beta_min, beta_max):
    np.testing.assert_array_equal(
        schedules.get_time_schedule(T, device=CPU).numpy(), np.asarray(jsched.get_time_schedule(T)))
    for ours, theirs in zip(
        schedules.get_sigma_schedule(T, beta_min, beta_max, geometric, device=CPU),
        jsched.get_sigma_schedule(T, beta_min, beta_max, geometric),
    ):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    ours = schedules.PosteriorCoefficients.create(T, beta_min, beta_max, geometric, device=CPU)
    theirs = jsched.PosteriorCoefficients.create(T, beta_min, beta_max, geometric)
    for field in ("betas", "alphas_cumprod", "posterior_variance", "posterior_mean_coef1",
                  "posterior_mean_coef2", "posterior_log_variance_clipped",
                  "sqrt_recipm1_alphas_cumprod"):
        a, b = getattr(ours, field), np.asarray(getattr(theirs, field))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)


def test_geometric_domain_raises():
    with pytest.raises(ValueError, match="use_geometric"):
        schedules.PosteriorCoefficients.create(T, 0.1, 20.0, use_geometric=True, device=CPU)


def test_posterior_step_matches_jax():
    x0, xt, noise = randn(1, 4, 8, 8, 3), randn(2, 4, 8, 8, 3), randn(3, 4, 8, 8, 3)
    t = np.array([0, 1, 2, 3])
    want = jsched.sample_posterior_with_noise(
        jsched.PosteriorCoefficients.create(T, 0.1, 20.0),
        jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t), jnp.asarray(noise))
    got = schedules.sample_posterior_with_noise(
        schedules.PosteriorCoefficients.create(T, 0.1, 20.0, device=CPU),
        nchw(x0), nchw(xt), torch.from_numpy(t), nchw(noise))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the t == 0 row takes no noise
    np.testing.assert_allclose(
        nhwc(got)[0], np.asarray(jsched.sample_posterior_with_noise(
            jsched.PosteriorCoefficients.create(T, 0.1, 20.0), jnp.asarray(x0[:1]),
            jnp.asarray(xt[:1]), jnp.asarray(t[:1]), jnp.zeros_like(noise[:1])))[0],
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """(cfg, port generator with non-trivial weights, JAX generator, its params)."""
    cfg = tiny_config()
    net = randomize_parameters_(NCSNpp.from_config(cfg), 0).eval()
    gen = JNCSNpp.from_config(cfg)
    k = jax.random.PRNGKey(0)
    template = gen.init({"params": k, "dropout": k},
                        jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz)))
    return cfg, net, gen, flax_params_from_port(net, template)


def test_t4_sampler_matches_jax(tiny):
    cfg, net, gen, params = tiny
    b, s, c = 4, cfg.image_size, cfg.num_channels
    x_init = randn(20, b, s, s, c)
    zs = [randn(30 + i, b, cfg.nz) for i in range(T)]
    noises = [randn(40 + i, b, s, s, c) for i in range(T)]

    jcoeff = jsched.PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max)
    apply = jax.jit(lambda x, t, z: gen.apply({"params": params}, x, t, z, train=False))
    x = jnp.asarray(x_init)
    for step, i in enumerate(range(T - 1, -1, -1)):
        t = jnp.full((b,), i, jnp.int32)
        x = jsched.sample_posterior_with_noise(
            jcoeff, apply(x, t, jnp.asarray(zs[step])), x, t, jnp.asarray(noises[step]))
    want = np.asarray(x)

    coeff = schedules.PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device=CPU)
    got = schedules.sample_from_model_with_noise(
        coeff, net, T, nchw(x_init), [torch.from_numpy(z) for z in zs],
        [nchw(n) for n in noises])
    assert np.std(want - x_init) > 0.05  # the generator moved the samples
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)


def test_sampler_draws_from_its_generator(tiny):
    cfg, net, _, _ = tiny
    coeff = schedules.PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device=CPU)

    def run(seed):
        rng = torch.Generator().manual_seed(seed)
        x_init = torch.randn((2, 3, 16, 16), generator=rng)
        return schedules.sample_from_model(coeff, net, T, x_init, cfg.nz, rng)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 3, 16, 16) and torch.isfinite(a).all()


def _experiment(tmp_path, tiny, batch_size=3):
    cfg, _, _, params = tiny
    exp = tmp_path / "saved_info" / "dd_gan" / "cifar10" / "tiny"
    exp.mkdir(parents=True)
    (exp / "content_args.json").write_text(
        json.dumps(cfg.replace(batch_size=batch_size, exp="tiny").to_dict()))
    save_torch_netg(str(exp / "netG_1.pth"), jax.tree.map(np.asarray, params))
    return exp


def test_cli_writes_pngs_on_cpu(tmp_path, monkeypatch, tiny):
    _experiment(tmp_path, tiny)
    monkeypatch.chdir(tmp_path)
    test_cli.main(["--dataset", "cifar10", "--exp", "tiny", "--epoch_id", "1",
                   "--device", "cpu", "--seed", "5"])
    out = tmp_path / "generated_samples" / "cifar10"
    pngs = sorted(out.glob("sample_*.png"))
    assert len(pngs) == 3
    img = np.asarray(Image.open(pngs[0]))
    assert img.shape == (16, 16, 3) and img.std() > 5  # not a blank image


def test_cli_refusals(tmp_path, monkeypatch, tiny):
    exp = _experiment(tmp_path, tiny)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="Inception"):
        test_cli.main(["--dataset", "cifar10", "--exp", "tiny", "--compute_fid",
                       "--device", "cpu"])
    (exp / "netG_1.pth").rename(exp / "netG_1.ckpt")
    with pytest.raises(FileNotFoundError, match="converter"):
        test_cli.main(["--dataset", "cifar10", "--exp", "tiny", "--epoch_id", "1",
                       "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="netG_7"):
        test_cli.main(["--dataset", "cifar10", "--exp", "tiny", "--epoch_id", "7",
                       "--device", "cpu"])


def test_generate_samples_trims_the_last_batch(tmp_path, tiny):
    cfg, net, _, _ = tiny
    sample = test_cli.make_sampler(cfg, net, 4, torch.device(CPU), torch.Generator().manual_seed(0))
    n = test_cli.generate_samples(sample, 10, 4, tmp_path, save_npy=True)
    assert n == 10
    assert len(list(tmp_path.glob("*.png"))) == 10 and len(list(tmp_path.glob("*.npy"))) == 10
    assert np.load(tmp_path / "9.npy").shape == (3, 16, 16)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_png_encoder_round_trips(tmp_path, shape):
    arr = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    (tmp_path / "a.png").write_bytes(encode_png(arr))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)
    x = np.random.RandomState(1).rand(6, 5, 3).astype(np.float32)
    save_image(x, tmp_path / "b.png")
    want = np.clip(x * 255 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")), want)

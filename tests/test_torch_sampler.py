"""The port's sampling path against the JAX package: schedules, the
posterior step, the whole reverse sampler with injected noise on the tiny
flagship-shaped generator (T=4) and on the six levels of the CelebA-HQ 256
recipe cut to image 64 and nf 16 (T=2), and the sampler CLI on the CPU.

The sampler is compared with the JAX package's generator and
`sample_posterior_with_noise` looped over the same x_init, z's and noises
(atol 1e-4 over T generator calls, f32). The CLI also samples from the
JAX package's own `netG_*.ckpt` and scores an FID set with --compute_fid.
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
from ddgan_tpu.eval import fid as jfid
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train.checkpoint import save_netg

from ddgan_torch.cli import test_cli
from ddgan_torch.diffusion import schedules
from ddgan_torch.models import NCSNpp
from ddgan_torch.utils import encode_png, randomize_parameters_, save_image

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    celeba256_config, flax_params_from_port, nchw, nhwc, one_torch_thread, randn, tiny_config,
)

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


def _jax_template(gen, cfg):
    """The JAX generator's variables, zero-filled from `jax.eval_shape` of
    its init (running the init op by op takes tens of seconds): the port's
    weights fill it."""
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: gen.init(
        {"params": k, "dropout": k},
        jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz))))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


@pytest.fixture(scope="module")
def tiny():
    """(cfg, port generator with non-trivial weights, JAX generator, its params)."""
    cfg = tiny_config()
    net = randomize_parameters_(NCSNpp.from_config(cfg), 0).eval()
    gen = JNCSNpp.from_config(cfg)
    return cfg, net, gen, flax_params_from_port(net, _jax_template(gen, cfg))


def _sampler_parity(cfg, net, gen, params, b, seed):
    """The port's reverse sampler and the JAX package's, on the same
    x_init, z's and noises; (port, JAX, x_init) in NHWC."""
    steps, s, c = cfg.num_timesteps, cfg.image_size, cfg.num_channels
    x_init = randn(seed, b, s, s, c)
    zs = [randn(seed + 10 + i, b, cfg.nz) for i in range(steps)]
    noises = [randn(seed + 20 + i, b, s, s, c) for i in range(steps)]

    jcoeff = jsched.PosteriorCoefficients.create(steps, cfg.beta_min, cfg.beta_max)
    apply = jax.jit(lambda x, t, z: gen.apply({"params": params}, x, t, z, train=False))
    x = jnp.asarray(x_init)
    for step, i in enumerate(range(steps - 1, -1, -1)):
        t = jnp.full((b,), i, jnp.int32)
        x = jsched.sample_posterior_with_noise(
            jcoeff, apply(x, t, jnp.asarray(zs[step])), x, t, jnp.asarray(noises[step]))

    coeff = schedules.PosteriorCoefficients.create(steps, cfg.beta_min, cfg.beta_max, device=CPU)
    got = schedules.sample_from_model_with_noise(
        coeff, net, steps, nchw(x_init), [torch.from_numpy(z) for z in zs],
        [nchw(n) for n in noises])
    return nhwc(got), np.asarray(x), x_init


def test_t4_sampler_matches_jax(tiny):
    cfg, net, gen, params = tiny
    got, want, x_init = _sampler_parity(cfg, net, gen, params, b=4, seed=20)
    assert np.std(want - x_init) > 0.05  # the generator moved the samples
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def six_level():
    """(cfg, port generator, JAX generator, its params) at the CelebA-HQ 256
    structure cut to image 64, nf 16."""
    cfg = celeba256_config(tiny=True)
    net = randomize_parameters_(NCSNpp.from_config(cfg), 3).eval()
    gen = JNCSNpp.from_config(cfg)
    return cfg, net, gen, flax_params_from_port(net, _jax_template(gen, cfg))


def test_t2_six_level_sampler_matches_jax(six_level):
    cfg, net, gen, params = six_level
    assert cfg.num_timesteps == 2 and len(cfg.ch_mult) == 6
    got, want, x_init = _sampler_parity(cfg, net, gen, params, b=2, seed=50)
    assert np.std(want - x_init) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cli_samples_a_celeba256_experiment_on_cpu(tmp_path, monkeypatch, six_level):
    """The sampler CLI on an experiment saved with the CelebA-HQ 256
    recipe's structure (dataset celeba_256, T=2, six levels; image 64)."""
    cfg, _, _, params = six_level
    exp = tmp_path / "saved_info" / "dd_gan" / "celeba_256" / "tiny256"
    exp.mkdir(parents=True)
    (exp / "content_args.json").write_text(
        json.dumps(cfg.replace(batch_size=2, exp="tiny256").to_dict()))
    save_torch_netg(str(exp / "netG_3.pth"), jax.tree.map(np.asarray, params))
    monkeypatch.chdir(tmp_path)
    test_cli.main(["--dataset", "celeba_256", "--exp", "tiny256", "--epoch_id", "3",
                   "--device", "cpu", "--seed", "5"])
    pngs = sorted((tmp_path / "generated_samples" / "celeba_256").glob("sample_*.png"))
    assert len(pngs) == 2
    img = np.asarray(Image.open(pngs[0]))
    assert img.shape == (64, 64, 3) and img.std() > 5


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


def test_cli_refusals(tmp_path, monkeypatch, capsys, tiny):
    """What the CLI once refused it now does: it samples from the JAX
    package's netG_*.ckpt (generator output equal to the JAX generator's on
    the same weights) and scores an FID set with --compute_fid, equal to the
    JAX package's FID of the same two directories. A missing netG is still
    refused."""
    cfg, net, gen, params = tiny
    exp = tmp_path / "saved_info" / "dd_gan" / "cifar10" / "tiny"
    exp.mkdir(parents=True)
    (exp / "content_args.json").write_text(
        json.dumps(cfg.replace(batch_size=3, exp="tiny").to_dict()))
    save_netg(exp, 1, jax.tree.map(np.asarray, params))
    assert sorted(p.name for p in exp.iterdir()) == ["content_args.json", "netG_1.ckpt"]

    args = test_cli.build_parser().parse_args(["--dataset", "cifar10", "--exp", "tiny"])
    loaded = test_cli.load_generator(exp, test_cli.load_config(exp, args), 1, torch.device(CPU))
    x, z = randn(60, 3, 16, 16, 3), randn(61, 3, cfg.nz)
    t = np.array([3, 1, 0], np.int32)
    want = gen.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z),
                     train=False)
    with torch.no_grad():
        got = nhwc(loaded(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z)))
    assert np.std(np.asarray(want)) > 0.05
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)

    real = tmp_path / "real"
    real.mkdir()
    rs = np.random.RandomState(7)
    for i in range(6):
        Image.fromarray(rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(real / f"{i}.png")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDGAN_TPU_INCEPTION_RANDOM", "0")
    monkeypatch.delenv("DDGAN_TPU_INCEPTION_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="Real image directory"):
        test_cli.main(["--dataset", "cifar10", "--exp", "tiny", "--epoch_id", "1", "--device",
                       "cpu", "--compute_fid", "--real_img_dir", str(tmp_path / "none")])
    fid = test_cli.main(["--dataset", "cifar10", "--exp", "tiny", "--epoch_id", "1",
                         "--device", "cpu", "--seed", "5", "--compute_fid", "--num_fid_samples",
                         "7", "--real_img_dir", str(real), "--fid_output_path", "out/fid.txt"])
    assert f"FID = {fid}" in capsys.readouterr().out
    fake = tmp_path / "generated_samples" / "cifar10"
    assert sorted(p.name for p in fake.iterdir()) == [f"{i}.png" for i in range(7)]
    assert float((tmp_path / "out" / "fid.txt").read_text()) == fid
    want = jfid.calculate_fid_given_paths([str(fake), str(real)], batch_size=50, dims=2048)
    assert fid > 0 and abs(fid - want) <= 1e-4 * want

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

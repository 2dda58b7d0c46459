"""The port's PSO hyperparameter search (`ddgan_torch.pso`) and NIfTI
converters (`ddgan_torch.data.converters`) against the JAX package's, on
the CPU.

- tests/test_pso_hpo.py's cases on the port: grid snapping, convergence on
  a quadratic, the scoring functions, prepare/cleanup, the forked pool
  against sequential evaluation, the pso-optim preset.
- The swarm's trajectory (every position evaluated, with its seed, and the
  best) equal to the JAX package's for the same evaluate_fn and seed; the
  scoring functions equal on the same files; SimpleShow equal on one log;
  the stringified-bounds runner.
- The in-process evaluator (a tiny config trained by `ddgan_torch.train` in
  `tmp_path`) and the subprocess one (the port's train CLI); the refusal of
  forked workers around the in-process evaluator on CUDA.
- `nii_to_png`, `nii_to_npy` and `npy_to_image`: the port's PNGs decode to
  the pixels of the JAX package's (PIL's) and its arrays are equal; a
  resize to another size raises, naming ROADMAP item 13.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import ddgan_tpu.pso as jpso
from ddgan_tpu.data import converters as jconverters
from ddgan_tpu.pso import scoring as jscoring
from ddgan_tpu.pso.vali_show import SimpleShow as JSimpleShow

from ddgan_torch.data import converters, write_nifti
from ddgan_torch.pso import PSO, Particle, SimpleShow, cli, evaluate, loss_stability_score
from ddgan_torch.pso import normalize_score, run, scoring
from ddgan_torch.pso.evaluate import cleanup_experiment, make_evaluator, prepare_config
from ddgan_torch.utils import decode_pngs

from _torch_port import one_torch_thread  # noqa: F401  (an autouse fixture)

SPACE = {
    "lr_g": [1e-6, 1e-3],
    "batch_size": [16, 128],
    "step": {"batch_size": 16},
}
TINY = dict(dataset="synthetic", image_size=8, num_channels=1, num_channels_dae=8, ch_mult=[1],
            num_res_blocks=1, attn_resolutions=[4], nz=4, z_emb_dim=8, n_mlp=1, t_emb_dim=8,
            ngf=4, num_timesteps=2, batch_size=2, limited_iter=2, dropout=0.0, lazy_reg=2,
            seed=1, num_workers=0)


# ---------------------------------------------------------------- the swarm
def test_particle_respects_grid_and_bounds():
    p = Particle(SPACE, seed=0)
    assert 1e-6 <= p.position["lr_g"] <= 1e-3
    assert p.position["batch_size"] in range(16, 129, 16)
    p.velocity = {"lr_g": 1.0, "batch_size": 1000.0}
    p.update_position(SPACE)
    assert p.position["lr_g"] == 1e-3
    assert p.position["batch_size"] == 128


def test_pso_converges_on_quadratic():
    space = {"x": [-5.0, 5.0], "y": [-5.0, 5.0], "step": {}}

    def evaluate_fn(pos, seed):
        return (pos["x"] - 1.0) ** 2 + (pos["y"] + 2.0) ** 2

    pso = PSO(space, evaluate_fn, num_particles=8, num_iterations=30, do_clamping=True, seed=3)
    best = pso.optimize()
    assert abs(best["x"] - 1.0) < 0.5 and abs(best["y"] + 2.0) < 0.5
    assert pso.global_best_score < 0.3


@pytest.mark.parametrize("clamping", [True, False])
def test_trajectory_equals_the_jax_packages(clamping):
    """Both swarms ask for the same positions with the same seeds, in the
    same order, and end at the same best: the same `random.Random` streams."""
    space = {"lr": [1e-4, 1e-1], "layers": [1, 9], "wd": [0.0, 1.0], "step": {"layers": 2}}

    def run_swarm(cls):
        calls = []

        def evaluate_fn(pos, seed):
            calls.append((dict(pos), seed))
            return (pos["lr"] - 0.03) ** 2 + (pos["layers"] - 5) ** 2 + pos["wd"]

        swarm = cls(space, evaluate_fn, num_particles=4, num_iterations=9,
                    do_clamping=clamping, seed=11)
        best = swarm.optimize()
        return calls, best, swarm.global_best_score

    got, want = run_swarm(PSO), run_swarm(jpso.PSO)
    assert len(got[0]) >= 4 * 7 and got == want


def _quadratic_eval(position, seed):
    """Module-level (picklable) evaluator for the multiprocessing pool."""
    return (position["lr"] - 0.03) ** 2 + (position["layers"] - 3) ** 2


def test_pso_pool_backend_matches_sequential():
    space = {"lr": (0.001, 0.1), "layers": (1, 5), "step": {"layers": 1}}

    def run_swarm(use_mp):
        pso = PSO(space, _quadratic_eval, num_particles=3, num_iterations=2, seed=7,
                  use_multiprocessing=use_mp)
        return pso.optimize(), pso.global_best_score

    assert run_swarm(True) == run_swarm(False)


# ---------------------------------------------------------------- scoring
def test_scoring_functions(tmp_path):
    assert normalize_score(150, 0, 300) == 0.5
    assert normalize_score(1e9, 0, 300) == 1.0
    assert scoring.combined_score(0.5, 150) == 0.5 * 0.5 + 0.5 * 0.5
    losses = [{"epoch": 1, "G_loss": 1.2, "D_loss": 1.4},
              {"epoch": 2, "G_loss": 2.0, "D_loss": 2.0}]
    (tmp_path / "losses.json").write_text(json.dumps(losses))
    assert abs(loss_stability_score(str(tmp_path)) - (0.0 + (1.0 + 0.7)) / 2) < 1e-9
    assert loss_stability_score(str(tmp_path / "missing")) == float("inf")
    assert scoring.compute_loss(str(tmp_path)) == float("inf")
    (tmp_path / "final_loss.txt").write_text("0.25\n")
    assert scoring.compute_loss(str(tmp_path)) == 0.25


@pytest.mark.parametrize("losses", [
    [{"epoch": 1, "G_loss": 0.4, "D_loss": 0.9}, {"epoch": 2, "G_loss": 1.1, "D_loss": 1.35}],
    [{"epoch": 1, "G_loss": 3.0}],
    [],
    "not json",
    {"G_loss": 1.0},
])
def test_scores_equal_the_jax_packages_on_the_same_files(tmp_path, losses):
    text = losses if isinstance(losses, str) else json.dumps(losses)
    (tmp_path / "losses.json").write_text(text)
    (tmp_path / "final_loss.txt").write_text("0.731\n")
    assert scoring.loss_stability_score(str(tmp_path)) == \
        jscoring.loss_stability_score(str(tmp_path))
    assert scoring.compute_loss(str(tmp_path)) == jscoring.compute_loss(str(tmp_path))
    for args in ((0.3, 120.0), (2.0, -5.0, 0.0, 1.0, 0.0, 300.0), (0.5, 0.5, 1.0, 1.0)):
        assert scoring.combined_score(*args) == jscoring.combined_score(*args)
        assert normalize_score(*args[:1], 0.1, 0.9) == jscoring.normalize_score(*args[:1], 0.1, 0.9)


def test_simple_show_equals_the_jax_packages():
    log = "\n".join(["header"] + [f"Epoch 1, Iteration {i}, G Loss: {0.5 + i / 10:.8f}, "
                                  f"D Loss: {1.3 - i / 20:.8f}" for i in range(5)] + ["tail"])
    assert SimpleShow(log).get_loss() == JSimpleShow(log).get_loss()


# ---------------------------------------------------------------- evaluation
def test_prepare_and_cleanup(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("configs")
    Path("configs/config.json").write_text(json.dumps(
        {"dataset": "synthetic", "exp": "x", "seed": 1, "num_epoch": 99}))
    path, config = prepare_config("configs/config.json", {"lr_g": 1e-4}, 42)
    assert os.path.exists(path) and config["exp"] == "pso_eval_42"
    assert config["num_epoch"] == 1 and config["lr_g"] == 1e-4
    assert prepare_config("configs/config.json", {}, 7, num_epoch=5)[1]["num_epoch"] == 5
    exp_path = os.path.join("saved_info/dd_gan", config["dataset"], config["exp"])
    os.makedirs(exp_path)
    cleanup_experiment(config, 42)
    assert not os.path.exists(path) and not os.path.exists(exp_path)


def _tiny_base(tmp_path, monkeypatch, **extra):
    monkeypatch.chdir(tmp_path)
    os.makedirs("configs")
    Path("configs/config.json").write_text(json.dumps({**TINY, **extra}))


def _leftovers(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if "pso_eval_" in p.name or p.name.startswith("config_"))


@pytest.mark.parametrize("mode", ["inprocess", "subprocess"])
def test_an_evaluation_trains_scores_and_cleans_up(tmp_path, monkeypatch, mode):
    """One particle's evaluation of the tiny config: the in-process one runs
    `ddgan_torch.train.train` with the position and seed, the subprocess one
    the port's train CLI on the written config."""
    _tiny_base(tmp_path, monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the subprocess's torch: one thread, as here
    trained = []
    if mode == "inprocess":
        from ddgan_torch.train import loop

        real_train = loop.train

        def spy(cfg, dataset=None, device=None):
            trained.append((cfg.lr_g, cfg.seed, cfg.exp, cfg.num_epoch, device))
            return real_train(cfg, dataset, device)

        monkeypatch.setattr("ddgan_torch.train.train", spy)
    stability = make_evaluator(mode=mode, scoring="stability", device="cpu")
    score = stability({"lr_g": 2e-4}, 5)
    assert np.isfinite(score) and score >= 0.0
    if mode == "inprocess":
        combined = make_evaluator(mode=mode, scoring="combined", device="cpu")({"lr_g": 2e-4}, 6)
        # the loss half: the final G loss, clamped to [0, 1]; FID off
        assert 0.0 < combined <= 0.5
        assert [t[:2] + t[3:] for t in trained] == [(2e-4, 5, 1, torch.device("cpu")),
                                                    (2e-4, 6, 1, torch.device("cpu"))]
        assert all(t[2].startswith("pso_eval_") for t in trained)
    assert _leftovers(tmp_path) == []
    assert json.loads(Path("configs/config.json").read_text()) == TINY


@pytest.mark.parametrize("mode,scoring", [("inprocess", "stability"),
                                          ("subprocess", "combined")])
def test_failed_evaluation_scores_inf(tmp_path, monkeypatch, mode, scoring):
    """A training that fails scores inf under either scoring; in a
    subprocess, its non-zero exit is the failure (the combined score of a
    missing final_loss.txt alone would be 0.5)."""
    _tiny_base(tmp_path, monkeypatch, dataset="lsun")  # needs an image decoder: raises
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    evaluate_fn = make_evaluator(mode=mode, scoring=scoring, device="cpu")
    assert evaluate_fn({"lr_g": 1e-4}, 1) == float("inf")
    assert _leftovers(tmp_path) == []


def test_run_bash_command_returns_stdout_and_raises_with_stderr():
    from ddgan_torch.utils import run_bash_command

    assert run_bash_command("echo out; echo err >&2") == "out\n"
    with pytest.raises(RuntimeError, match=r"exited 3:\nwhy\n"):
        run_bash_command("echo why >&2; exit 3")


def test_forked_pool_around_the_inprocess_evaluator_on_cuda_is_refused(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "resolve_device", lambda *a: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="forked processes, which cannot use CUDA"):
        cli.main(["--use_multiprocessing", "--num_particles", "2"])
    assert not (tmp_path / "configs").exists()  # refused before any work
    evaluate.check_pool("subprocess", torch.device("cuda"), True)
    evaluate.check_pool("inprocess", torch.device("cpu"), True)


def test_pso_optim_preset(tmp_path, monkeypatch):
    """--preset pso-optim: stability scoring, FID off, num_epoch=5 per
    evaluation (pso-optim.py:366, 396-445, 564), as the JAX CLI sets them."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDGAN_TORCH_DEVICE", "cpu")
    os.makedirs("configs")
    Path("configs/config.json").write_text(json.dumps({"dataset": "synthetic", "exp": "x",
                                                       "seed": 1}))
    Path("configs/space.json").write_text(json.dumps({"lr_g": [1e-5, 1e-3], "step": {}}))
    captured = {}

    def fake_make_evaluator(base, mode, scoring, with_fid, eval_num_epoch, device):
        captured.update(scoring=scoring, with_fid=with_fid, eval_num_epoch=eval_num_epoch,
                        device=device)
        return lambda pos, seed: pos["lr_g"]

    monkeypatch.setattr(cli, "make_evaluator", fake_make_evaluator)
    best = cli.main(["--preset", "pso-optim", "--search_space", "configs/space.json",
                     "--num_particles", "3", "--num_iterations", "2"])
    assert captured == {"scoring": "stability", "with_fid": False, "eval_num_epoch": 5,
                        "device": torch.device("cpu")}
    assert os.path.exists("best_hyperparameters.json") and 1e-5 <= best["lr_g"] <= 1e-3
    written = json.loads(Path("configs/config.json").read_text())
    assert written["limited_iter"] == 202 and written["batch_size"] == 8


def test_runner_takes_stringified_bounds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Path("space.json").write_text(json.dumps({"lr_g": "[1e-5, 1e-3]", "batch_size": "[16, 64]",
                                              "step": {}}))
    seen = []

    def fake_make_evaluator(scoring):
        assert scoring == "stability"
        return lambda pos, seed: seen.append(pos) or pos["lr_g"]

    monkeypatch.setattr(run, "make_evaluator", fake_make_evaluator)
    best = run.main(["--search_space", "space.json", "--num_particles", "2",
                     "--num_iterations", "1"])
    assert all(p["batch_size"] in (16, 32, 48, 64) for p in seen)
    assert json.loads(Path("best_hyperparameters.json").read_text()) == best


# ---------------------------------------------------------------- converters
@pytest.fixture
def volumes(tmp_path):
    rs = np.random.RandomState(0)
    infos = []
    for case in range(2):
        path = tmp_path / f"case{case}.nii.gz"
        write_nifti(path, rs.uniform(-50, 300, (8, 6, 4)).astype(np.float32))
        infos += [(str(path), "z", 1), (str(path), "z", 3), (str(path), "x", 2)]
    return infos


def test_nii_to_png_pixels_equal_the_jax_packages(volumes, tmp_path):
    # z slices are 8 x 6 (PIL size (6, 8)): a resize to their own size is a copy
    for only_z, resize in ((True, (6, 8)), (False, None)):
        dirs = {}
        for name, mod in (("jax", jconverters), ("port", converters)):
            dirs[name] = tmp_path / f"{name}_{only_z}"
            mod.nii_to_png(volumes, save_dir=str(dirs[name]), only_z=only_z,
                           do_resize_to=resize)
        names = sorted(p.name for p in dirs["jax"].iterdir())
        assert names == sorted(p.name for p in dirs["port"].iterdir())
        assert len(names) == (4 if only_z else 6)
        for n in names:
            got = decode_pngs([(dirs["port"] / n).read_bytes()])[0]
            want = np.asarray(Image.open(dirs["jax"] / n))
            np.testing.assert_array_equal(got[..., 0] if got.ndim == 3 else got, want)


@pytest.mark.parametrize("size", [(16, 16), (5, 9), (20, 3)])
def test_nii_to_png_resized_pixels_equal_the_jax_packages(volumes, tmp_path, size):
    """`do_resize_to` (width, height): PIL's default filter, bicubic, on
    every slice, shrinking and enlarging (`ddgan_tpu/data/converters.py:37-38`)."""
    dirs = {}
    for name, mod in (("jax", jconverters), ("port", converters)):
        dirs[name] = tmp_path / name
        mod.nii_to_png(volumes, save_dir=str(dirs[name]), only_z=False, do_resize_to=size)
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir()) and len(names) == 6
    for n in names:
        got = decode_pngs([(dirs["port"] / n).read_bytes()])[0][..., 0]
        want = np.asarray(Image.open(dirs["jax"] / n))
        assert want.shape == size[::-1]
        np.testing.assert_array_equal(got, want)


def test_compute_fid_on_a_slices_info_config_equals_the_jax_packages(volumes, tmp_path,
                                                                      monkeypatch):
    """`_compute_fid` of a config with a slices-info file: the real set at
    image_size² that both packages write, and the score read back from the
    FID file that the sampler CLI (here a stand-in) writes."""
    from ddgan_tpu.pso import evaluate as jevaluate

    (tmp_path / "slices.txt").write_text("".join(f"{a}, {b}, {c}\n" for a, b, c in volumes))
    commands = []

    def fake_cli(command):
        commands.append(command)
        out = command.split("--fid_output_path ")[1].split()[0].strip("'")
        Path(out).write_text("12.5\n")
        return ""

    monkeypatch.chdir(tmp_path)
    (tmp_path / "saved_info").mkdir()
    scores = {}
    for name, mod, args in (("jax", jevaluate, ()), ("port", evaluate, (torch.device("cpu"),))):
        monkeypatch.setattr(mod, "run_bash_command", fake_cli)
        config = {"save_dir": str(tmp_path / name), "exp": "e", "image_size": 16,
                  "path_to_slices_info": str(tmp_path / "slices.txt"), "dataset": "luna16",
                  "num_epoch": 1}
        scores[name] = mod._compute_fid(config, 3, *args)
    assert scores == {"jax": 12.5, "port": 12.5}
    assert "-m ddgan_torch.cli.test_cli" in commands[1] and "--compute_fid" in commands[1]
    names = sorted(p.name for p in (tmp_path / "jax" / "real_images").iterdir())
    assert len(names) == 4  # the z slices
    for n in names:
        got = decode_pngs([(tmp_path / "port" / "real_images" / n).read_bytes()])[0][..., 0]
        want = np.asarray(Image.open(tmp_path / "jax" / "real_images" / n))
        assert got.shape == (16, 16)
        np.testing.assert_array_equal(got, want)


def test_npy_converters_equal_the_jax_packages(volumes, tmp_path):
    for name, mod in (("jax", jconverters), ("port", converters)):
        mod.nii_to_npy(volumes, save_dir=str(tmp_path / f"npy_{name}"), lim=3)
        mod.nii_to_npy_3d(str(tmp_path), save_dir=str(tmp_path / f"vol_{name}"))
    for kind in ("npy", "vol"):
        names = sorted(p.name for p in (tmp_path / f"{kind}_jax").iterdir())
        assert names == sorted(p.name for p in (tmp_path / f"{kind}_port").iterdir()) and names
        for n in names:
            np.testing.assert_array_equal(np.load(tmp_path / f"{kind}_port" / n),
                                          np.load(tmp_path / f"{kind}_jax" / n))
    rs = np.random.RandomState(1)
    src = tmp_path / "samples"
    src.mkdir()
    np.save(src / "grey.npy", rs.randn(6, 5).astype(np.float32))
    np.save(src / "rgb.npy", rs.randn(3, 4, 5).astype(np.float32))
    for name, mod in (("jax", jconverters), ("port", converters)):
        mod.npy_to_image(str(src), save_dir=str(tmp_path / f"img_{name}"))
    for n in ("grey.png", "rgb.png"):
        got = decode_pngs([(tmp_path / "img_port" / n).read_bytes()])[0]
        want = np.asarray(Image.open(tmp_path / "img_jax" / n).convert("RGB"))
        np.testing.assert_array_equal(got, want)

"""The port's sampler CLI over ranks (`ddgan_torch/cli/test_cli.py`) on the
CPU, with gloo ranks spawned by `parallel.launch` (a `file://` rendezvous,
a deadline).

Rank r draws from one generator seeded with seed + r. The files are held
against a one-process emulation of the R ranks that calls the sampler
(`diffusion.sample_from_model`) on each rank's generator in (call, rank)
order: with --compute_fid, {i}.png is the i-th sample in (call, rank, row)
order and each rank samples `batch_size` a call; the FID runs once, on
rank 0, after every file is on disk (a recorder in place of Inception,
`_torch_dist.cli_rank_with_fid_recorder`). Plain sampling sizes each
rank's batch to ceil(batch / R) and writes the first `batch_size`. At one
rank the CLI draws what it always drew, and the rank count of the
experiment's saved training args is never used.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ddgan_torch import parallel
from ddgan_torch.cli import test_cli
from ddgan_torch.config import Config
from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model
from ddgan_torch.models import NCSNpp
from ddgan_torch.utils import randomize_parameters_

from _torch_dist import cli_rank_with_fid_recorder

CPU = torch.device("cpu")
SEED = 5


@pytest.fixture
def experiment(tmp_path, monkeypatch):
    """A tiny cifar10 experiment whose saved training args ran on 8 ranks
    over gloo; the working directory is tmp_path."""
    cfg = Config(dataset="cifar10", image_size=8, num_channels=3, num_channels_dae=8,
                 ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[4], nz=4, z_emb_dim=8,
                 n_mlp=1, t_emb_dim=8, num_timesteps=2, batch_size=3, exp="tiny",
                 num_process_per_node=8, what_backend="gloo")
    exp = tmp_path / "saved_info" / "dd_gan" / "cifar10" / "tiny"
    exp.mkdir(parents=True)
    (exp / "content_args.json").write_text(json.dumps(cfg.to_dict()))
    net = randomize_parameters_(NCSNpp.from_config(cfg), 7).eval()
    torch.save(net.state_dict(), exp / "netG_1.pth")
    (tmp_path / "real").mkdir()
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    return cfg, net


def emulate(cfg, net, world: int, per_rank: int, calls: int) -> np.ndarray:
    """The R ranks' samples in (call, rank, row) order as uint8 HWC pixels,
    from one process: rank r's generator seeded with SEED + r."""
    pos = PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                       cfg.use_geometric, device=CPU)
    rngs = [torch.Generator().manual_seed(SEED + r) for r in range(world)]
    out = []
    for _ in range(calls):
        for rng in rngs:
            x = torch.randn((per_rank, 3, cfg.image_size, cfg.image_size), generator=rng)
            out.append(sample_from_model(pos, net, cfg.num_timesteps, x, cfg.nz, rng))
    x = ((torch.cat(out) + 1.0) / 2.0).permute(0, 2, 3, 1).numpy()
    return np.clip(np.clip(x, 0.0, 1.0) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _pngs(pattern: str) -> dict:
    folder = Path("generated_samples") / "cifar10"
    return {p.name: np.asarray(Image.open(p)) for p in sorted(folder.glob(pattern))}


ARGV = ["--dataset", "cifar10", "--exp", "tiny", "--epoch_id", "1", "--device", "cpu",
        "--seed", str(SEED)]


def test_fid_set_over_two_ranks_equals_the_emulation(experiment, tmp_path):
    """batch 3 a rank, 10 samples: call 0 gives 0-5, call 1 gives 6-8 on
    rank 0 and 9 on rank 1 (its other two rows are not written)."""
    cfg, net = experiment
    args = test_cli.build_parser().parse_args(
        ARGV + ["--compute_fid", "--num_fid_samples", "10", "--real_img_dir", "real",
                "--num_process_per_node", "2"])
    args.world, args.what_backend, args.fid_log = 2, "gloo", str(tmp_path / "fid.log")
    parallel.launch(args, cli_rank_with_fid_recorder,
                    init_method=f"file://{tmp_path}/rendezvous", device="cpu", deadline_s=120)
    want = emulate(cfg, net, world=2, per_rank=3, calls=2)
    got = _pngs("[0-9]*.png")
    assert sorted(got) == sorted(f"{i}.png" for i in range(10))
    for i in range(10):
        assert np.array_equal(got[f"{i}.png"], want[i]), i
    assert (tmp_path / "fid.log").read_text() == "0 10\n"  # once, on rank 0, every file there
    assert (tmp_path / "fid_score.txt").read_text() == "1.25\n"


def test_plain_sampling_over_two_ranks_through_the_cli(experiment, tmp_path):
    """batch 5 over 2 ranks: ceil(5/2) = 3 a rank, sample_0-4 in (rank, row)
    order; through `main`, which spawns the ranks."""
    cfg, net = experiment
    assert test_cli.main(ARGV + ["--batch_size", "5", "--num_process_per_node", "2"],
                         init_method=f"file://{tmp_path}/rendezvous", deadline_s=120) is None
    want = emulate(cfg, net, world=2, per_rank=3, calls=1)
    got = _pngs("sample_*.png")
    assert sorted(got) == sorted(f"sample_{i}.png" for i in range(5))
    for i in range(5):
        assert np.array_equal(got[f"sample_{i}.png"], want[i]), i


def test_one_rank_is_unchanged_and_ignores_the_saved_rank_count(experiment, tmp_path,
                                                                 monkeypatch):
    """The saved args say 8 processes a node; without the flag the CLI runs
    in this process (a spawn would raise here) and draws from one generator
    seeded with the seed, in both modes."""
    cfg, net = experiment
    monkeypatch.setattr(parallel, "launch", lambda *a, **k: pytest.fail("spawned"))
    args = test_cli.build_parser().parse_args(ARGV)
    assert args.num_process_per_node == 1
    assert test_cli.load_config(Path("saved_info/dd_gan/cifar10/tiny"), args) \
        .num_process_per_node == 8  # the saved value stays in the config; the CLI ignores it
    test_cli.main(ARGV + ["--batch_size", "4"])
    want = emulate(cfg, net, world=1, per_rank=4, calls=1)
    got = _pngs("sample_*.png")
    assert len(got) == 4 and all(np.array_equal(got[f"sample_{i}.png"], want[i])
                                 for i in range(4))
    calls = []
    monkeypatch.setattr("ddgan_torch.eval.fid.calculate_fid_given_paths",
                        lambda paths, **kw: calls.append(len(list(Path(paths[0]).glob("[0-9]*"))))
                        or 2.5)
    monkeypatch.setattr("ddgan_torch.eval.inception.default_feature_fn", lambda **kw: None)
    assert test_cli.main(ARGV + ["--compute_fid", "--num_fid_samples", "7",
                                 "--real_img_dir", "real"]) == 2.5
    want = emulate(cfg, net, world=1, per_rank=3, calls=3)
    got = _pngs("[0-9]*.png")
    assert calls == [7] and sorted(got) == sorted(f"{i}.png" for i in range(7))
    assert all(np.array_equal(got[f"{i}.png"], want[i]) for i in range(7))


def test_rank_batches_follow_the_jax_cli():
    assert [test_cli.rank_batch(63, r, False) for r in (1, 2, 4, 64, 100)] == [63, 32, 16, 1, 1]
    assert [test_cli.rank_batch(64, r, True) for r in (1, 2, 8)] == [64, 64, 64]

"""`tools/quality_soak_torch.py`, the port's quality soak, against the JAX
package's soak tools (`tools/quality_soak.py`, `tools/quality_soak256.py`,
`tools/quality_e2e.py`): the same toy images, data files and training
flags; then one tiny soak on the CPU end to end (a SIGKILL, a resume, the
snapshots and the record), its FIDs in a cheap injected feature space
(a real FID's 2048² sqrtm takes ~20 s here; `test_torch_eval.py` holds the
real FID against the JAX package's)."""

from __future__ import annotations

import argparse
import ast
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "quality_soak_torch.py"
sys.path.insert(0, str(ROOT / "tools"))

import quality_e2e  # noqa: E402  (the JAX tools: module level imports no JAX)
import quality_soak  # noqa: E402
import quality_soak256  # noqa: E402
import quality_soak_torch as soak  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ddgan_tpu", "quality_e2e", "quality_soak",
             "quality_soak256", "msgpack", "lmdb"}


def _imports(tree) -> list[tuple[str, ast.AST]]:
    """(root module, node) of every import in `tree`."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], node) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append((node.module.split(".")[0], node))
    return out


def test_tool_imports_no_jax():
    """No JAX, JAX package or JAX tool; PIL only in the JPEG writer; importing
    the tool loads none of them."""
    tree = ast.parse(TOOL.read_text())
    roots = {r for r, _ in _imports(tree)}
    assert not roots & FORBIDDEN
    assert roots <= {"__future__", "argparse", "contextlib", "dataclasses", "json", "os",
                     "pickle", "re", "signal", "shutil", "subprocess", "sys", "tempfile",
                     "time", "pathlib", "typing", "numpy", "torch", "ddgan_torch", "PIL"}
    writer = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == "make_jpeg_folder")
    pil = [node for r, node in _imports(tree) if r == "PIL"]
    assert pil and all(any(node is m for m in ast.walk(writer)) for node in pil)
    import subprocess

    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(TOOL.parent)!r}); "
         "import quality_soak_torch; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         f"{FORBIDDEN | {'PIL'}!r}))"],
        capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("size", [32, 256])
def test_toy_image_is_quality_e2e(size):
    assert np.array_equal(soak.PALETTE, quality_e2e.PALETTE)
    for seed in range(32):
        a = soak.toy_image(np.random.RandomState(seed), size)
        b = quality_e2e.toy_image(np.random.RandomState(seed), size)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _pixels(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _mean_std(batch: np.ndarray) -> np.ndarray:
    """A cheap 6-dim feature space: each channel's mean and deviation."""
    return np.concatenate([batch.mean(axis=(1, 2)), batch.std(axis=(1, 2))], axis=1)


def _args(recipe: str, root: Path, *extra: str):
    return soak.parse_args(["--recipe", recipe, "--root", str(root / "port"),
                            "--out", str(root / "record.json"), *extra])


@pytest.mark.parametrize("recipe", ["flagship", "celeba256"])
def test_data_equal_the_jax_tools(recipe, tmp_path):
    """Training files byte for byte, real and held-out PNGs pixel for pixel,
    against the JAX tools' writers and held-out draws
    (tools/quality_soak.py:263-270, tools/quality_soak256.py:212-217)."""
    n_train, n_real, n_hold = 12, 5, 4
    args = _args(recipe, tmp_path, "--n-train", str(n_train), "--n-real", str(n_real),
                 "--fid-samples", str(n_hold), "--dims", "6")
    soak.Soak(args, feature_fn=_mean_std).prepare()
    port, jax_root = Path(args.root), tmp_path / "jax"
    size, stride = soak.RECIPES[recipe].image_size, soak.RECIPES[recipe].stride
    if recipe == "flagship":
        quality_soak.make_cifar_pickles(jax_root, n_train, n_real, args.seed)
        files = [f"data/cifar-10-batches-py/data_batch_{b}" for b in range(1, 6)]
        data = pickle.loads((port / files[0]).read_bytes())[b"data"]
        assert data.shape == (3, 3 * 32 * 32)
    else:
        quality_soak256.make_jpeg_folder(jax_root, n_train, n_real, size, args.seed)
        files = [f"data/train/imgs/img_{i:05d}.jpg" for i in range(n_train)]
    for name in files:
        assert (port / name).read_bytes() == (jax_root / name).read_bytes(), name
    assert sorted(p.name for p in (port / "real").iterdir()) == \
        sorted(p.name for p in (jax_root / "real").iterdir())
    for p in (jax_root / "real").iterdir():
        assert np.array_equal(_pixels(port / "real" / p.name), _pixels(p)), p.name
    assert len(list((port / "real_holdout").iterdir())) == n_hold
    for i in range(n_hold):
        rng = np.random.RandomState(args.seed * stride + n_train + n_real + i)
        want = (quality_e2e.toy_image(rng, size) * 255).astype(np.uint8)
        assert np.array_equal(_pixels(port / "real_holdout" / f"img_{i:05d}.png"), want)
    with np.load(port / "real_stats.npz") as f:
        assert f["mu"].shape == (6,) and f["sigma"].shape == (6, 6)
    assert np.isfinite(float((port / "fid_floor.txt").read_text()))


@pytest.mark.parametrize("recipe,jax_tool", [("flagship", quality_soak),
                                             ("celeba256", quality_soak256)])
@pytest.mark.parametrize("resume", [False, True])
def test_train_flags_equal_the_jax_tools(recipe, jax_tool, resume, tmp_path):
    """Flag for flag the JAX tool's `train_cmd`, apart from the entry point
    (`train_ddgan.py` there, `python -m ddgan_torch.cli.train_cli` here)."""
    args = _args(recipe, tmp_path, "--nf", "96", "--batch-size", "12", "--seed", "5",
                 "--ckpt-every", "3", "--content-every", "2")
    ours = soak.train_cmd(args, 7, resume)
    theirs = jax_tool.train_cmd(argparse.Namespace(**vars(args)), 7, resume)
    assert ours[:3] == [sys.executable, "-m", "ddgan_torch.cli.train_cli"]
    assert theirs[1].endswith("train_ddgan.py")
    assert ours[3:] == theirs[2:]


@pytest.mark.parametrize("recipe", ["flagship", "celeba256"])
def test_train_seed_sets_only_the_train_cli_seed(recipe, tmp_path):
    """--train-seed (default --seed) is the train CLI's --seed alone: the
    data draws and the FID samples keep --seed, and the record holds both."""
    same = _args(recipe, tmp_path, "--seed", "5")
    other = _args(recipe, tmp_path, "--seed", "5", "--train-seed", "9")
    assert (same.train_seed, other.train_seed, other.seed) == (5, 9, 5)

    argv = soak.train_argv(same, 7, False)
    assert argv[argv.index("--seed") + 1] == "5"
    ours, base = soak.train_argv(other, 7, True), soak.train_argv(same, 7, True)
    at = ours.index("--seed") + 1
    assert ours[at] == "9" and ours[:at] + ours[at + 1:] == base[:at] + base[at + 1:]
    rec = soak.Soak(other).record(False)
    assert (rec["seed"], rec["train_seed"], rec["config"]["train_seed"]) == (5, 9, 9)


def test_recipe_defaults():
    """The soaks' lengths, lr horizons (the JAX soaks' first segments),
    snapshots and sizes (the JAX tools' data); a segment that would not end
    at a content.pth save under the schedule is refused."""
    f = soak.parse_args(["--recipe", "flagship"])
    c = soak.parse_args(["--recipe", "celeba256"])
    assert (f.schedule_epochs, c.schedule_epochs) == tuple(
        json.loads((ROOT / n).read_text())["config"]["segments"][0]
        for n in ("QUALITY_r03.json", "QUALITY_256_r05.json")) == (100, 32)
    assert soak.parse_args(["--recipe", "celeba256", "--segments", "6",
                            "--schedule-epochs", "0"]).segments == [6]
    for bad in (["--segments", "6"], ["--segments", "36"]):
        with pytest.raises(SystemExit):
            soak.parse_args(["--recipe", "celeba256", *bad])
    assert (f.n_train, f.n_real, f.nf, f.batch_size, f.seed, f.exp) == \
        (20000, 2048, 128, 64, 42, "soak")
    assert (f.segments, f.ckpt_every, f.content_every, f.fid_samples) == ([10, 20], 5, 5, 1024)
    assert (c.n_train, c.n_real, c.nf, c.batch_size, c.seed, c.exp) == \
        (2048, 1024, 64, 8, 23, "soak256")
    assert (c.segments, c.ckpt_every, c.content_every, c.fid_samples) == ([8, 16], 4, 4, 1024)
    assert Path(f.out).name == "QUALITY_torch_r01.json"
    assert Path(c.out).name == "QUALITY_256_torch_r01.json"


def test_epoch_seconds_by_process():
    log = (f"{soak.SEGMENT_MARK}a\n[epoch 0] 4 iters in 2.000s (2.00 it/s), saves 1.500s, G 1 D 2\n"
           "[epoch 1] 4 iters in 1.000s (4.00 it/s), saves 0.100s, G 1 D 2\n"
           f"{soak.SEGMENT_MARK}b\n=> Loaded checkpoint (epoch 2)\n"
           "[epoch 2] 4 iters in 3.000s (1.33 it/s), saves 0.200s, G 1 D 2\n"
           "[epoch 3] 8 iters in 3.000s (2.67 it/s), saves 0.200s, G 1 D 2\n")
    out = soak.epoch_seconds(log)
    assert [(r["process"], r["epoch"], r["steady"]) for r in out["epochs"]] == \
        [(0, 0, False), (0, 1, True), (1, 2, False), (1, 3, True)]
    assert out["steady"] == {"epochs": 2, "iters": 12, "s": 4.0, "steps_per_s": 3.0,
                             "s_per_epoch_median": 2.0}


def soak_lr(base: float, epochs_done: int, num_epoch: int) -> float:
    """The reference's CosineAnnealingLR(T_max=num_epoch, eta_min=1e-5)."""
    return 1e-5 + 0.5 * (base - 1e-5) * (1 + np.cos(np.pi * epochs_done / num_epoch))


def content_lr(exp: Path) -> float:
    """G's learning rate that content.pth's scheduler state holds."""
    content = torch.load(exp / "content.pth", map_location="cpu", weights_only=False)
    assert content["schedulerG"]["T_max"] == content["args"]["num_epoch"]
    return content["schedulerG"]["_last_lr"][0]


def test_tiny_soak_end_to_end(tmp_path, monkeypatch):
    """A tiny flagship soak on the CPU (one step an epoch) on the JAX soak's lr
    schedule (every process at --num_epoch 100): the first segment
    SIGKILLed after its first content.pth save, resumed and stopped after
    epoch 1's, then a second segment stopped after epoch 2's; netG_0..2
    scored, the raw and EMA snapshots at both segments' ends, and the
    record."""
    monkeypatch.setenv("DDGAN_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the train processes: tiny tensors
    monkeypatch.chdir(tmp_path)
    args = ["--recipe", "flagship", "--root", str(tmp_path / "run"),
            "--out", str(tmp_path / "out" / "record.json"), "--n-train", "5", "--n-real", "8",
            "--nf", "16", "--batch-size", "4", "--segments", "1", "2", "--kill-delay", "0",
            "--ckpt-every", "1", "--content-every", "1", "--fid-samples", "8", "--fid-batch", "8",
            "--dims", "6"]
    rec = soak.main(args, feature_fn=_mean_std)
    assert json.loads((tmp_path / "out" / "record.json").read_text()) == \
        json.loads(json.dumps(rec))
    exp = tmp_path / "run" / "saved_info" / "dd_gan" / "cifar10" / "soak"

    kill, resumed, second = rec["events"]
    assert kill["event"] == "hard_kill" and kill["at_logged_epoch"] >= 1
    assert resumed == {**resumed, "event": "segment_done", "resume": True, "target": 1,
                       "num_epoch": 100}
    # content.pth of the epoch before the kill: at most one epoch redone
    assert kill["at_logged_epoch"] - 1 <= resumed["resumed_from_epoch"] <= kill["at_logged_epoch"]
    assert second == {**second, "event": "segment_done", "target": 2, "num_epoch": 100,
                      "resumed_from_epoch": 2}
    assert content_lr(exp) == pytest.approx(soak_lr(1.6e-4, 3, 100))
    losses = json.loads((exp / "losses.json").read_text())
    assert [e["epoch"] for e in losses] == [1, 2, 3]
    assert rec["losses_epochs_logged"] == 3 and rec["resume_continuity_ok"]
    assert rec["sweep_complete"]

    assert [r["epoch"] for r in rec["ema_fid_curve"]] == [0, 1, 2]
    assert [(r["epoch"], r["ema_weights_equal_netG_e"]) for r in rec["ema_vs_raw"]] == \
        [(1, True), (2, True)]
    for r in rec["ema_vs_raw"]:
        assert r["fid_ema"] == rec["ema_fid_curve"][r["epoch"]]["fid_ema"]
        assert np.isfinite(r["fid_raw"]) and r["fid_raw"] != r["fid_ema"]
    content = torch.load(exp / "content.pth", map_location="cpu", weights_only=False)
    raw = torch.load(exp / "netG_90002.pth", weights_only=True)
    ema = torch.load(exp / "netG_80002.pth", weights_only=True)
    netg = torch.load(exp / "netG_2.pth", weights_only=True)
    assert raw.keys() == content["netG_dict"].keys() == ema.keys() == netg.keys()
    assert all(torch.equal(raw[k], content["netG_dict"][k]) for k in raw)
    assert all(torch.equal(ema[k], netg[k]) for k in ema)
    assert all(torch.equal(ema[k], content["emaG"][k]) for k in content["emaG"])
    assert any(not torch.equal(raw[k], ema[k]) for k in content["emaG"])
    for i in (0, 1, 2, 90001, 90002):
        assert (tmp_path / "run" / f"fid_{i}.txt").exists()
    assert not (tmp_path / "run" / "fid_80002.txt").exists()  # netG_2's FID stands for it

    assert np.isfinite(rec["fid_floor_two_real_draws"])
    assert rec["feature_space"].startswith("a feature function")
    assert rec["device"].startswith("not measured") or rec["device"]
    steady = rec["epoch_seconds"]["steady"]
    assert [(r["process"], r["epoch"]) for r in rec["epoch_seconds"]["epochs"]][-2:] == \
        [(1, 1), (2, 2)]
    assert steady["epochs"] == 0 and steady["steps_per_s"] is None  # one epoch a process
    ref = rec["jax_reference"]
    assert ref["file"] == "QUALITY_r03.json" and ref["fid_floor_two_real_draws"] == \
        json.loads((ROOT / "QUALITY_r03.json").read_text())["fid_floor_two_real_draws"]
    assert [r["epoch"] for r in ref["ema_fid_curve"]] == [0]
    assert rec["config"]["segments"] == [1, 2] and rec["config"]["schedule_epochs"] == 100


def test_injected_features_stay_in_one_process(tmp_path, monkeypatch):
    """`test_cli.main`'s `feature_fn` / `dims` are refused for spawned ranks,
    which could not receive a function of the caller's."""
    from ddgan_torch.cli import test_cli

    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "cifar10", "--exp", "none", "--device", "cpu",
            "--num_process_per_node", "2"]
    for kw in ({"feature_fn": _mean_std, "dims": 6}, {"dims": 64}):
        with pytest.raises(ValueError, match="one process only"):
            test_cli.main(argv, **kw)

"""Package rules of the port (`ddgan_torch`): it never imports JAX, the
JAX package, PIL or msgpack (its flax reader is its own), scipy only for the
FID's matrix square root, its entry points (the train CLIs among them) run on the
GPU unless the CPU is asked for, its config schema is the JAX package's,
and `chip_smoke.py` fails rather than reporting a result when it has no GPU
or no checkout around it.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ddgan_tpu.config import Config as JConfig

from ddgan_torch import _device
from ddgan_torch.cli import main_cli, test_cli, train_cli
from ddgan_torch.config import Config
from ddgan_torch.diffusion import schedules

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddgan_tpu", "PIL", "msgpack")


def _port_sources():
    return sorted((ROOT / "ddgan_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_import_no_jax():
    sources = _port_sources()
    assert len(sources) > 15
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}


def test_scipy_only_in_the_fid():
    users = sorted(str(p.relative_to(ROOT)) for p in _port_sources()
                   if "scipy" in _imported_roots(p))
    assert users == ["ddgan_torch/eval/fid.py"]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys, ddgan_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ddgan_torch.__path__, 'ddgan_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15


def test_pso_and_the_content_bridge_import_no_jax():
    """The modules a user runs without JAX in reach: the PSO search, its CLIs
    and the content.ckpt bridge (which reads and writes flax's format on its
    own)."""
    mods = ["ddgan_torch.pso", "ddgan_torch.pso.cli", "ddgan_torch.pso.run",
            "ddgan_torch.pso.evaluate", "ddgan_torch.compat.content",
            "ddgan_torch.data.converters", "ddgan_torch.train.pso_step"]
    code = (
        "import importlib, sys\n"
        f"for n in {mods!r}: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout + res.stderr


def test_library_layers_import_no_jax():
    """The layer library, the fused ops and the registry helpers, each
    alone (their JAX counterparts import JAX and flax)."""
    mods = ["ddgan_torch.nn.legacy", "ddgan_torch.ops.fused_act", "ddgan_torch.models.registry"]
    code = (
        "import importlib, sys\n"
        f"for n in {mods!r}: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout + res.stderr


# modules of the JAX package's models/, nn/ and ops/ the port has no file
# for: its Pallas sources (ported as CUDA in ddgan_torch/csrc/ behind
# ops/fir2x.py and ops/pair_conv.py) and the width-s2d layout, a TPU measure
NOT_MIRRORED = {"ops/experimental", "ops/s2d.py"}


def test_models_nn_ops_mirror_the_jax_package():
    """Every module of ddgan_tpu/{models,nn,ops} has its counterpart of the
    same name in ddgan_torch, apart from NOT_MIRRORED."""
    def names(pkg):
        out = set()
        for sub in ("models", "nn", "ops"):
            for p in (ROOT / pkg / sub).iterdir():
                if p.name != "__pycache__" and (p.suffix == ".py" or p.is_dir()):
                    out.add(f"{sub}/{p.name}")
        return out

    missing = names("ddgan_tpu") - names("ddgan_torch") - NOT_MIRRORED
    assert not missing
    assert NOT_MIRRORED <= names("ddgan_tpu")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(_device.ENV_VAR, raising=False)


def test_entry_points_need_a_gpu_unless_the_cpu_is_asked_for(no_gpu, monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match=_device.ENV_VAR):
        _device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        schedules.PosteriorCoefficients.create(4, 0.1, 20.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        schedules.get_time_schedule(4)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main(["--dataset", "cifar10", "--exp", "none"])
    # the train CLIs raise before they write the config or train
    for main, argv in ((train_cli.main, ["--use_config_file", "True", "--dataset", "synthetic"]),
                       (main_cli.main, ["--dataset", "synthetic"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
        assert not (tmp_path / "configs").exists() and not (tmp_path / "saved_info").exists()
    from ddgan_torch.train import loop

    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(Config(dataset="synthetic"))

    assert _device.resolve_device("cpu") == torch.device("cpu")
    assert schedules.get_time_schedule(4, device="cpu").device.type == "cpu"
    monkeypatch.setenv(_device.ENV_VAR, "cpu")
    assert _device.resolve_device() == torch.device("cpu")
    devices = []
    monkeypatch.setattr(loop, "train", lambda cfg, device=None: devices.append(device))
    monkeypatch.setattr("ddgan_torch.train.train", loop.train)
    train_cli.main(["--dataset", "synthetic"])
    main_cli.main(["--dataset", "synthetic"])
    assert devices == [torch.device("cpu")] * 2
    assert schedules.PosteriorCoefficients.create(4, 0.1, 20.0).betas.device.type == "cpu"
    with pytest.raises(RuntimeError, match="unsupported"):
        _device.resolve_device("meta")


def test_pso_and_content_entry_points_need_a_gpu(no_gpu, monkeypatch, tmp_path):
    """The PSO CLIs and the content converter raise without a GPU unless the
    CPU is asked for, before they write anything."""
    from ddgan_torch.compat import content
    from ddgan_torch.pso import cli as pso_cli
    from ddgan_torch.pso import evaluate

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pso_cli.main(["--num_particles", "1", "--num_iterations", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.make_evaluator()
    with pytest.raises(RuntimeError, match="CUDA"):
        content.main([str(tmp_path), "--to", "pth"])
    assert list(tmp_path.iterdir()) == []


def test_config_schema_is_the_jax_packages():
    def schema(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else f.default_factory()) for f in dataclasses.fields(cls)]

    assert len(schema(Config)) == 86
    assert schema(Config) == schema(JConfig)
    extra = Config.from_dict({"image_size": 32, "not_a_key": 3})
    assert extra.image_size == 32 and extra.not_a_key == 3


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_a_checkout(where, tmp_path):
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: chip_smoke.py runs for real here")
        script, cwd = ROOT / "chip_smoke.py", ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def _chip_smoke():
    """`chip_smoke.py` as a module (it runs nothing on import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_writes_its_real_set_filtered_as_pil_does(tmp_path):
    """Phase 30's real directory: PNGs whose rows take the filter PIL's
    adaptive heuristic picks (Sub and Paeth on smooth images), which both
    the port and PIL decode to the pixels written; the loader check passes
    on them and fails on a wrong pixel."""
    import io

    import numpy as np
    from PIL import Image

    from ddgan_torch.eval import fid
    from ddgan_torch.utils import decode_png

    cs = _chip_smoke()
    rs = np.random.RandomState(0)
    for side in (1, 5, 32):
        pixels = cs.smooth_image(rs, side)
        png, filters = cs.encode_png_adaptive(pixels)
        assert filters.shape == (side,) and filters.max() <= 4
        np.testing.assert_array_equal(decode_png(png), pixels)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png)).convert("RGB")),
                                      pixels)
    written = cs.write_filtered_set(tmp_path / "real", 60, 16, seed=1)
    assert written["filters"][1] > 0 and written["filters"][4] > 0
    got = cs.decode_check(fid, tmp_path / "real", written)
    assert got["files"] == 60 and got["row_filters_0_to_4"] == written["filters"]
    written["pixels"][59] = written["pixels"][59] ^ 1
    with pytest.raises(AssertionError, match="1 of 60"):
        cs.decode_check(fid, tmp_path / "real", written)


_PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__86e8aef5_8_fir2x_cu_e5131aab11up2x_\
kernelI13__nv_bfloat16Lb1EEEvPKT_PS2_iiiiiiiiiNS_4TapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__86e8aef5_8_fir2x_cu_e5131aab11up2x_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__86e8aef5_8_fir2x_cu_e5131aab13down2x_\
kernelIfLb0EEEvPKT_PS1_iiiiiiiiiNS_4TapsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 45 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__17c65626_15_pair_conv3x3_cu_42548afb19\
pair_conv3x3_kernelE14CUtensorMap_stS0_PKvPKfP13__nv_bfloat16iiiiiiiii' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 123 registers, used 2 barriers
"""


def test_chip_smoke_summarises_ptxas_per_kernel():
    spill0 = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    assert _chip_smoke().ptxas_summary(_PTXAS_REPORT) == [
        f"up2x_kernel<bf16, vector>: 40 registers; {spill0}",
        f"down2x_kernel<float, scalar>: 45 registers; {spill0}",
        "pair_conv3x3_kernel: 123 registers; 0 bytes stack frame, 8 bytes spill stores, "
        "8 bytes spill loads",
    ]


def test_chip_smoke_share_summary_reads_the_bound_criterion():
    """The lowest share of the bound counts only shapes whose bound is >= 5
    us; every shape where the library call is not slower is listed."""
    rows = [{"shape": [4, 64, 128, 128], "dtype": "bfloat16", "ms": 0.02, "library_ms": 0.4,
             "bound_ms": 0.0125},
            {"shape": [4, 64, 128, 128], "dtype": "float32", "ms": 0.05, "library_ms": 0.4,
             "bound_ms": 0.025},
            {"shape": [4, 512, 4, 4], "dtype": "bfloat16", "ms": 0.004, "library_ms": 0.004,
             "bound_ms": 0.0001}]
    out = _chip_smoke().share_summary("up2x", rows)
    assert out["lowest_share"] == pytest.approx(0.5) and out["at"] == "(4, 64, 128, 128) float32"
    assert out["shapes_with_bound_ge_5us"] == 2 and out["shapes"] == 3
    assert out["library_faster_at"] == ["(4, 512, 4, 4) bfloat16"]
    assert _chip_smoke().share_summary("none", rows[2:])["lowest_share"] is None

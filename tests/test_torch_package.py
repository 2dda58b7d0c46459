"""Package rules of the port (`ddgan_torch`): it never imports JAX, the
JAX package, PIL, msgpack or lmdb (its flax reader, its image readers and
its LMDB reader are its own), scipy only for the FID's matrix square root,
its JPEG, WebP and TIFF decoders build only into the git-ignored `ddgan_torch/_build/`,
its entry points (the train CLIs among them) run on the GPU unless the CPU
is asked for, its config schema is the JAX package's, every module of the
JAX package has its counterpart, its file helpers are the JAX package's,
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddgan_tpu", "PIL", "msgpack", "lmdb")


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
    """No module of the package imports a FORBIDDEN root; chip_smoke.py may
    import PIL and lmdb alone of them, as the references of its image and
    LMDB phases (47-52; lmdb where it is installed)."""
    sources = _port_sources()
    assert len(sources) > 15
    references = {"PIL", "lmdb"}
    bad = {str(p.relative_to(ROOT)): sorted(
               _imported_roots(p) & (set(FORBIDDEN) - (references if p.name == "chip_smoke.py"
                                                       else set())))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}
    assert "PIL" in _imported_roots(ROOT / "chip_smoke.py")


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


def test_image_file_modules_import_no_pil_or_jax():
    """The image readers of the port, each alone: the resize, the JPEG,
    WebP and TIFF decoders' bindings, the CIELAB conversion, the BMP and
    Netpbm readers, the
    volume cache, the host build helper, the datasets, the LMDB datasets
    and the FID loader (their JAX counterparts import PIL)."""
    mods = ["ddgan_torch.data.resize", "ddgan_torch.data.jpeg", "ddgan_torch.data.webp",
            "ddgan_torch.data.bmp", "ddgan_torch.data.netpbm", "ddgan_torch.data.tiff",
            "ddgan_torch.data.cielab", "ddgan_torch.data.slicecache", "ddgan_torch.ops._cxx",
            "ddgan_torch.utils",
            "ddgan_torch.data.datasets", "ddgan_torch.data.lmdb_datasets",
            "ddgan_torch.data.factory", "ddgan_torch.eval.fid"]
    code = (
        "import importlib, sys\n"
        f"for n in {mods!r}: importlib.import_module(n)\n"
        "from ddgan_torch.utils import decode_images\n"
        "from ddgan_torch.data.jpeg import decode_jpeg\n"
        "from ddgan_torch.data.webp import decode_webp\n"
        "from ddgan_torch.data.bmp import decode_bmp\n"
        "from ddgan_torch.data.netpbm import decode_netpbm\n"
        "from ddgan_torch.data.tiff import decode_tiff\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout + res.stderr
    sources = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"ddgan_torch/data/resize.py", "ddgan_torch/data/jpeg.py", "ddgan_torch/data/webp.py",
            "ddgan_torch/data/bmp.py", "ddgan_torch/data/netpbm.py", "ddgan_torch/data/tiff.py",
            "ddgan_torch/data/slicecache.py", "ddgan_torch/ops/_cxx.py",
            "ddgan_torch/data/cielab.py"} <= sources


def test_jpeg_decoder_builds_only_into_the_ignored_build_dir(tmp_path):
    """A copy of the package builds the decoder from its own source at first
    use: the one file it adds is the library under ddgan_torch/_build/,
    which .gitignore lists; a compiler that fails raises."""
    pkg = tmp_path / "ddgan_torch"
    shutil.copytree(ROOT / "ddgan_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p for p in tmp_path.rglob("*") if p.is_file()}
    code = ("import numpy as np\n"
            "from ddgan_torch.data.jpeg import decode_jpeg\n"
            "try:\n"
            "    decode_jpeg(b'\\xff\\xd8\\xff')\n"
            "except ValueError as e:\n"
            "    print('malformed:', e)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CXX")}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "malformed" in res.stdout, res.stdout + res.stderr
    added = {p for p in tmp_path.rglob("*") if p.is_file()} - before
    assert len(added) == 1
    (lib,) = added
    assert lib.parent == pkg / "_build" and lib.name.startswith("libjpeg_decode_")
    assert "ddgan_torch/_build/" in (ROOT / ".gitignore").read_text().split()
    # a failed build raises, naming the compiler's error; nothing else is tried
    lib.unlink()
    env["CXX"] = "false"
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "RuntimeError: false failed" in res.stderr, res.stderr
    assert not list((pkg / "_build").iterdir())


def test_webp_decoder_builds_only_into_the_ignored_build_dir(tmp_path):
    """As the JPEG decoder: a copy of the package builds webp_decode.cpp at
    first use into ddgan_torch/_build/ and adds nothing else; a malformed
    file raises ValueError, with no fallback."""
    pkg = tmp_path / "ddgan_torch"
    shutil.copytree(ROOT / "ddgan_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p for p in tmp_path.rglob("*") if p.is_file()}
    code = ("from ddgan_torch.data.webp import decode_webp\n"
            "try:\n"
            "    decode_webp(b'RIFF\\x04\\0\\0\\0WEBP')\n"
            "except ValueError as e:\n"
            "    print('malformed:', e)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CXX")}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "malformed" in res.stdout, res.stdout + res.stderr
    added = {p for p in tmp_path.rglob("*") if p.is_file()} - before
    assert [(p.parent, p.name.startswith("libwebp_decode_")) for p in added] == [
        (pkg / "_build", True)]


def test_gif_decoder_builds_only_into_the_ignored_build_dir(tmp_path):
    """As the JPEG decoder: a copy of the package builds gif_decode.cpp at
    first use into ddgan_torch/_build/ and adds nothing else; an LZW
    stream cut short raises ValueError, with no fallback."""
    pkg = tmp_path / "ddgan_torch"
    shutil.copytree(ROOT / "ddgan_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p for p in tmp_path.rglob("*") if p.is_file()}
    code = ("from ddgan_torch.data import gif\n"
            "try:\n"
            "    gif._lzw(b'\\x02\\x04', 0, 2, 64)\n"
            "except ValueError as e:\n"
            "    print('malformed:', e)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CXX")}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "malformed" in res.stdout, res.stdout + res.stderr
    added = {p for p in tmp_path.rglob("*") if p.is_file()} - before
    assert [(p.parent, p.name.startswith("libgif_decode_")) for p in added] == [
        (pkg / "_build", True)]


def test_tiff_decoder_builds_only_into_the_ignored_build_dir(tmp_path):
    """As the JPEG decoder: a copy of the package builds tiff_decode.cpp at
    first use into ddgan_torch/_build/ and adds nothing else; a malformed
    LZW strip raises ValueError, with no fallback."""
    pkg = tmp_path / "ddgan_torch"
    shutil.copytree(ROOT / "ddgan_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p for p in tmp_path.rglob("*") if p.is_file()}
    code = ("from ddgan_torch.data import tiff\n"
            "try:\n"
            "    tiff._decompress(5, b'\\x80\\xff', 64)\n"
            "except ValueError as e:\n"
            "    print('malformed:', e)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CXX")}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "malformed" in res.stdout, res.stdout + res.stderr
    added = {p for p in tmp_path.rglob("*") if p.is_file()} - before
    assert [(p.parent, p.name.startswith("libtiff_decode_")) for p in added] == [
        (pkg / "_build", True)]


# what the JAX package has and the port has no file of that name for, each
# with the port's counterpart
NOT_MIRRORED = {
    "ops/experimental": "the Pallas sources: CUDA in ddgan_torch/csrc/ behind ops/fir2x.py "
                        "and ops/pair_conv.py",
    "ops/s2d.py": "the width-s2d layout, a TPU measure of the same math (s2d_conv ignored)",
    "native": "the C++ cache of decoded LUNA16 volumes: data/slicecache.py",
    "_platform.py": "the JAX platform selection: _device.py",
    "compat/torch_import.py": "the reference .pth importer and exporter: compat/weights.py",
}
COUNTERPARTS = {"ops/experimental": ["csrc", "ops/fir2x.py", "ops/pair_conv.py"],
                "ops/s2d.py": [], "native": ["data/slicecache.py"], "_platform.py": ["_device.py"],
                "compat/torch_import.py": ["compat/weights.py"]}


def _package_names(pkg: str) -> set:
    """Every module and subpackage of `pkg`, and those of its subpackages,
    as paths relative to it (data files and build outputs apart)."""
    out = set()
    for p in (ROOT / pkg).iterdir():
        if p.name in ("__pycache__", "_build"):
            continue
        if p.suffix == ".py" or p.is_dir():
            out.add(p.name)
        if p.is_dir() and (p / "__init__.py").is_file():
            out.update(f"{p.name}/{q.name}" for q in p.iterdir()
                       if q.name != "__pycache__" and (q.suffix == ".py" or q.is_dir()))
    return out


def test_models_nn_ops_mirror_the_jax_package():
    """Every module and subpackage of ddgan_tpu (cli, compat, data,
    diffusion, eval, models, nn, ops, parallel, pso, train and the top
    level) has its counterpart of the same name in ddgan_torch, apart from
    NOT_MIRRORED, whose counterparts are there under their own names."""
    jax_names, port_names = _package_names("ddgan_tpu"), _package_names("ddgan_torch")
    assert {"cli", "compat", "data", "diffusion", "eval", "models", "nn", "ops", "parallel",
            "pso", "train"} <= jax_names
    missing = {n for n in jax_names - port_names
               if not any(n == m or n.startswith(m + "/") for m in NOT_MIRRORED)}
    assert missing == set()
    assert set(NOT_MIRRORED) <= jax_names - port_names
    for name, files in COUNTERPARTS.items():
        assert all(f in port_names for f in files), name


def test_parallel_and_train_mirror_the_jax_package():
    """Every module of ddgan_tpu/parallel and ddgan_tpu/train (ZeRO-1
    included) has its counterpart of the same name in ddgan_torch, and the
    import check above reads them (`_port_sources`)."""
    for sub in ("parallel", "train"):
        jax_mods = {p.name for p in (ROOT / "ddgan_tpu" / sub).glob("*.py")}
        port_mods = {p.name for p in (ROOT / "ddgan_torch" / sub).glob("*.py")}
        assert jax_mods <= port_mods, sub
    sources = set(_port_sources())
    for name in ("parallel/distributed.py", "parallel/mesh.py", "train/zero1.py"):
        assert ROOT / "ddgan_torch" / name in sources


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
    the port and PIL decode to the pixels written, and every 16th file in
    one of the other layouts in turn; the loader check passes on them
    (every file against PIL too) and fails on a wrong pixel."""
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
    n = cs.REAL_SET_EVERY * len(cs.REAL_SET_LAYOUTS)
    mixed = cs.write_filtered_set(tmp_path / "mixed", n, 32, seed=2, Image=Image)
    assert {f.suffix for f in fid.list_image_files(tmp_path / "mixed")} == {
        ".bmp", ".ppm", ".pgm", ".tif", ".jpg", ".png"}
    got = cs.decode_check(fid, tmp_path / "mixed", mixed, Image=Image)
    assert got["files"] == n and set(got["ms_by_layout"]) == set(cs.REAL_SET_LAYOUTS) | {
        "png filtered"}


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


@pytest.mark.parametrize("betas", [(0.5, 0.9), (0.9, 0.999)])
def test_chip_smoke_adam_ratio_bound_holds_and_is_reached(betas):
    """Phase 45's bound on how far one Adam step moves a weight, in units of
    lr: |m_hat| / sqrt(v_hat) stays within it for heavy-tailed gradients,
    and the gradients g_k = w_k / u_k reach it."""
    cs, (b1, b2) = _chip_smoke(), betas
    g = torch.randn(20000, 6, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    g = g * torch.exp(2 * torch.randn(20000, 6, dtype=torch.float64,
                                      generator=torch.Generator().manual_seed(1)))
    m = v = torch.zeros(20000, dtype=torch.float64)
    for t in range(1, 7):
        m, v = b1 * m + (1 - b1) * g[:, t - 1], b2 * v + (1 - b2) * g[:, t - 1] ** 2
        ratio = (m / (1 - b1 ** t)).abs() / (v / (1 - b2 ** t)).sqrt()
        bound = cs.adam_ratio_bound(b1, b2, t)
        assert float(ratio.max()) <= bound * (1 + 1e-12)
        worst = [(b1 ** (t - k) * (1 - b1)) / (b2 ** (t - k) * (1 - b2)) for k in range(1, t + 1)]
        m_w = sum((1 - b1) * b1 ** (t - k) * x for k, x in enumerate(worst, 1)) / (1 - b1 ** t)
        v_w = sum((1 - b2) * b2 ** (t - k) * x * x for k, x in enumerate(worst, 1)) / (1 - b2 ** t)
        assert abs(m_w) / v_w ** 0.5 == pytest.approx(bound, rel=1e-12)
    assert cs.adam_ratio_bound(b1, b2, 1) == 1.0


def test_chip_smoke_image_phases_hold_on_this_host(tmp_path):
    """Phases 47-48's and 56's host code on the CPU: the JPEG matrix and the
    resize cases against this machine's PIL, the matrices of every other
    format and coding (the layouts once refused among them), and the
    custom loader's first batches (baseline, progressive, arithmetic-coded,
    4:4:0 and h4v1 files) against the script's copy of the JAX transform
    arithmetic, which must equal the JAX package's own items; phase 48's
    codings put one of each kind in batches 0 and 1."""
    import numpy as np
    from PIL import Image

    import ddgan_tpu.data as jdata

    from ddgan_torch.data import make_dataset
    from ddgan_torch.train.loop import build_loader

    cs = _chip_smoke()
    jpeg = cs.jpeg_against_pil(Image)
    assert jpeg["exact"] == jpeg["files"] == 76
    resize = cs.resize_against_pil(Image)
    assert resize["exact"] == resize["cases"] == 171
    formats = cs.image_formats_against_pil(Image, "this machine's CPU")
    assert formats["exact"] == formats["files"] == 3292 and formats["once_refused_read"] == 9
    assert formats["malformed_refused"] == 29 and formats["refused_13i"] == 21
    assert sum(cs.CUSTOM_KINDS.values()) == cs.CUSTOM_IMAGES == 64
    first = [40, 7, 0, 63, 12, 30, 5, 9]
    kinds = cs.custom_kinds(first, cs.CUSTOM_IMAGES, seed=0)
    assert [kinds[i] for i in first[:6]] == list(cs.CUSTOM_KINDS)
    assert {k: kinds.count(k) for k in cs.CUSTOM_KINDS} == cs.CUSTOM_KINDS
    cs.write_custom_jpegs(Image, tmp_path / "c", 6, 40, 36, seed=1,
                          kinds=["baseline", "progressive", "arithmetic",
                                 "arithmetic progressive", "4:4:0", "h4v1"])
    kw = dict(dataset="custom", data_dir=str(tmp_path / "c"), mode="train", do_resize="yes",
              to_tensor_transform="yes", use_normalize="yes", CenterCrop="yes", image_size=32,
              num_channels=3, batch_size=3)
    cfg = Config(**kw)
    ds = make_dataset(cfg)
    loader = build_loader(cfg, ds, cfg.batch_size)
    loader.set_epoch(0)
    idx = loader._indices()[:3]
    times, images = cs.loader_seconds(loader, 0, 2)
    assert len(times) == 2 and images[0].shape == (3, 32, 32, 3)
    want = cs.pil_reference_items(Image, [ds.images_all[i] for i in idx], 32)
    np.testing.assert_array_equal(images[0], want)
    jds = jdata.make_dataset(JConfig(**kw))
    np.testing.assert_array_equal(np.stack([jds[int(i)][0] for i in idx]), want)


def test_chip_smoke_webp_phases_hold_on_this_host():
    """Phases 54-55's host code on the CPU: the WebP matrix against this
    machine's PIL, and phase 55's LMDB values (lossy at qualities 60-95 and
    methods 0-6, and lossless) decoded as PIL decodes them."""
    import io

    import numpy as np
    from PIL import Image

    from ddgan_torch.utils import decode_images

    cs = _chip_smoke()
    out = cs.webp_against_pil(Image)
    assert out["exact"] == out["files"] >= 187 and out["malformed_refused"] >= 10
    values = list(cs.lsun_values(Image, "webp").values())
    assert len(values) == cs.LSUN_IMAGES + cs.LSUN_LOSSLESS
    assert sum(v[12:16] == b"VP8L" for v in values) == cs.LSUN_LOSSLESS
    for got, v in zip(decode_images(values[::9] + values[-2:]), values[::9] + values[-2:]):
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(v)).convert("RGB")))


def test_file_helpers_match_the_jax_package(tmp_path, capsys):
    """copy_file, copy_directory, move_file (replace / keep / rename),
    find_python_command and install_package, each on a temp tree of its
    own, against `ddgan_tpu/utils.py:42-108`: the same returns and the same
    files after each call."""
    import ddgan_tpu.utils as jutils

    from ddgan_torch import utils as tutils

    def tree(root: Path) -> dict:
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                if p.is_file()}

    def run(mod, root: Path) -> list:
        (root / "src" / "sub").mkdir(parents=True)
        (root / "src" / "a.txt").write_text("a")
        (root / "src" / "sub" / "b.txt").write_text("b")
        (root / "dst").mkdir()
        (root / "dst" / "a.txt").write_text("old")
        rel = lambda p: os.path.relpath(p, root)  # noqa: E731
        out = [rel(mod.copy_file(root / "src" / "a.txt", root / "dst" / "a.txt")),
               (root / "dst" / "a.txt").read_text(),
               rel(mod.copy_file(root / "src" / "a.txt", root / "dst" / "a.txt", replace=True)),
               rel(mod.copy_file(root / "src" / "a.txt", root / "new" / "x.txt", rename="c.txt")),
               rel(mod.copy_directory(root / "src", root / "copy")),
               rel(mod.copy_directory(root / "src", root / "copy")),
               rel(mod.copy_directory(root / "dst", root / "copy", replace=True)),
               rel(mod.copy_directory(root / "src", root / "x" / "y", rename="z")),
               rel(mod.move_file(root / "src" / "a.txt", root / "dst" / "a.txt")),
               rel(mod.move_file(root / "src" / "a.txt", root / "moved" / "m.txt")),
               rel(mod.move_file(root / "dst" / "a.txt", root / "moved" / "m.txt",
                                 replace=True, rename="n.txt")),
               mod.find_python_command()]
        mod.install_package("lmdb")
        return out + [tree(root)]

    want = run(jutils, tmp_path / "jax")
    printed_jax = capsys.readouterr().out
    got = run(tutils, tmp_path / "port")
    assert got == want and got[-2] == sys.executable
    assert capsys.readouterr().out == printed_jax and "lmdb" in printed_jax

"""The benchmark is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric added as new files are found without an edit to a
file that is there; `BENCHMARK.json` keeps to the contract's characters and
shapes; and a run needs a card."""

import json
import re
import shutil
import subprocess
import sys

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_files_are_found_without_editing_old_ones(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "celeba256.json").read_text())
    conf["name"] = "lsun256"
    conf["config"].update(num_timesteps=4, r1_gamma=1.0, lr_g=1.6e-4, batch_size=8)
    (b / "configs" / "lsun256.json").write_text(json.dumps(conf))
    (b / "traffic" / "train_b4.json").write_text(json.dumps({"kind": "train", "batch": 4,
                                                             "pool_batches": 4}))
    (b / "limits" / "lsun256.train_b4.json").write_text(json.dumps({"loss": 1.0}))
    (b / "metrics" / "steps_seen.py").write_text(
        "def read(ctx, suffix):\n    return ctx.trace.units if ctx.kind == suffix else None\n")
    spec["configs"].append({"name": "lsun256", "source": "x", "reduced": [], "why": "x",
                            "file": "benchmark/configs/lsun256.json"})
    spec["workloads"].append({"name": "lsun256.train_b4", "config": "lsun256",
                              "traffic": "train_b4", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "train step",
                              "moves": "train_samples_per_s", "workloads": ["lsun256.train_b4"]})
    spec["end_to_end"][0]["workloads"].append("lsun256.train_b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = f"""
import json, sys, types
sys.path.insert(0, {str(tmp_path)!r})
from benchmark import harness
cell = harness.load_cell("lsun256.train_b4")
ctx = types.SimpleNamespace(kind="train", trace=types.SimpleNamespace(units=10))
print(json.dumps([cell.batch, cell.cfg["num_timesteps"], cell.limits,
                  [m["name"] for m in cell.end_to_end], harness.read_per_layer(cell, ctx)]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    batch, steps, limits, e2e, per_layer = json.loads(out.stdout.strip().splitlines()[-1])
    assert (batch, steps, limits) == (4, 4, {"loss": 1.0})
    assert e2e == ["train_samples_per_s", "setup_s"]
    assert per_layer == {"steps_seen.train": {"value": 10.0, "unit": "steps"}}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_names_units_and_shapes_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["benchmark"]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in SPEC["workloads"]] + [
        c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert all(NAME.match(k) and k in conf["config"] for k in c["reduced"])
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()


def test_every_cell_reports_what_its_metrics_move():
    from benchmark import harness

    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert (ROOT / "benchmark" / "metrics" / f"{m['name'].partition('.')[0]}.py").exists()


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cifar10.train",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr

"""BENCHMARK.json keeps to the benchmark's contract, every file it names is
found, and adding a configuration, a traffic mix, a cell or a per-layer
metric takes new files and manifest entries only (a worked example)."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(run.__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(MANIFEST["command"]) <= 32
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for cell in cells:
        spec = run.resolve(MANIFEST, cell, ROOT)
        got = [m["name"] for m in spec.end_to_end]
        assert "setup_s" in got and len(got) >= 2
        assert spec.per_layer
        for m in spec.per_layer:  # a per-layer metric moves an end-to-end one its cell reports
            assert m["moves"] in got
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_named_file_is_found(cell):
    spec = run.resolve(MANIFEST, cell, ROOT)
    assert spec.config["reduced"] == []
    assert spec.limits
    for m in spec.per_layer:
        assert callable(run.metric_reader(m["name"]))
    assert (ROOT / "portbench" / "kinds" / f"{spec.traffic['kind']}.py").exists()


def _digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_adding_a_config_traffic_cell_and_metric_takes_new_files_only(tmp_path, monkeypatch):
    """The worked example of ``portbench/README.md``: a doubled-radius SSG
    configuration, a smaller corpus, a cell of the two and a metric of the
    traced stretch, added as new files and manifest entries."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "pn2_ssg_biomass.json").read_text())
    cfg["model"]["doubled_radius"] = True
    cfg["name"] = "pn2_ssg_dr_biomass"
    (pb / "configs" / "pn2_ssg_dr_biomass.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "train_b36.json").read_text())
    tr["plots"] = 36
    (pb / "traffic" / "train_b36_small.json").write_text(json.dumps(tr))
    (pb / "limits" / "ssgdr_train_small.json").write_text(json.dumps({"loss_gap": 0.01}))
    (pb / "metrics" / "copy_ms.py").write_text(
        "def read(s):\n    t = s.get('trace')\n"
        "    return None if not t else 1e3 * t['device_s'].get('copy', 0) / s['trace_units']\n")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": cfg["name"], "source": "https://github.com/cczls1991/DL_Biomass",
                         "file": "portbench/configs/pn2_ssg_dr_biomass.json", "reduced": [],
                         "why": "the recorded doubled-radius run"})
    m["workloads"].append({"name": "ssgdr_train_small", "config": cfg["name"],
                           "traffic": "train_b36_small", "chips": 1, "why": "example"})
    for e in m["end_to_end"]:
        if e["name"] == "train_clouds_per_s":
            e["workloads"].append("ssgdr_train_small")
    m["per_layer"].append({"name": "copy_ms.train", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "device (H100)",
                           "moves": "train_clouds_per_s", "workloads": ["ssgdr_train_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    monkeypatch.setattr(run, "HERE", pb)
    spec = run.resolve(m, "ssgdr_train_small", tmp_path)
    assert spec.config["model"]["doubled_radius"] and spec.traffic["plots"] == 36
    assert [x["name"] for x in spec.per_layer] == ["copy_ms.train"]
    read = run.metric_reader("copy_ms.train")
    assert read({"trace": {"device_s": {"copy": 0.002}}, "trace_units": 4}) == 0.5
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())  # no existing file edited


def test_metric_readers_return_nothing_without_a_trace():
    for m in MANIFEST["per_layer"]:
        assert run.metric_reader(m["name"])({}) is None


def test_judge():
    assert run.judge({"a": 0.1, "b": 0.2}, {"a": 0.1, "b": 0.3})
    assert not run.judge({"a": 0.11}, {"a": 0.1})
    assert not run.judge({}, {"a": 0.1})
    assert not run.judge({"a": float("inf")}, {"a": 0.1})
    assert not run.judge({"a": float("nan")}, {"a": 0.1})

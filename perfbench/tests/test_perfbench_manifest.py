"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name under perfbench/."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "perfbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(kind):
    names = [entry["name"] for entry in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_configs():
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert _line(cfg["source"]) and _line(cfg["why"])
        path = ROOT / cfg["file"]
        assert path.is_file() and path.parent == HERE / "configs"
        assert path.stem == cfg["name"]
        assert (HERE / "configs" / f"{cfg['name']}.py").is_file()
        assert (HERE / "reference" / f"{cfg['name']}.py").is_file()
        assert json.loads(path.read_text())["reduced"] == cfg["reduced"]


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and _line(cell["why"])
        assert NAME.match(cell["traffic"])
        spec = json.loads((HERE / "workloads" / f"{cell['name']}.json").read_text())
        assert spec["config"] == cell["config"] and spec["chips"] == cell["chips"]
        assert spec["why"] == cell["why"]
        assert (HERE / "catalogs" / f"{spec['catalog']['maker']}.py").is_file()
        config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
        assert list(spec["initials"]) == config["free"]
        assert set(spec["check"]["limits"]) == {"lnp_gap", "accept_margin", "accept_rule",
                                                "stray_moves", "finite_mismatch",
                                                "ckpt_mismatch", "no_steps_checked"}


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        layers.add(m["layer"])
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for cell in cells:
        assert sum(cell in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_paths_hold_only_names():
    for path in HERE.rglob("*"):
        if "_cache" in path.parts or "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

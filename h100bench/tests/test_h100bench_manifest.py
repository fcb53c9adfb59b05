"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "h100bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and (ROOT / p).is_dir()
        assert not p.endswith("_torch") and p != "benchmarks"
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST).encode()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts():
    named = MANIFEST["configs"] + MANIFEST["workloads"] + MANIFEST["end_to_end"] + \
        MANIFEST["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"]) and NAME.match(w["traffic"])


def test_metrics_keys_bounds_and_layers():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one in each cell
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cells_files_are_found_by_name(cell):
    from h100bench.run import load_cell

    w, config, traffic, _ = load_cell(cell, ROOT)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("h100bench/configs/") and config["name"] == w["config"]
    assert config["reduced"] == entry["reduced"]
    assert (HERE / "kinds" / f"{traffic['kind']}.py").exists()
    assert (HERE / "limits" / f"{cell}.json").exists()
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (HERE / "metrics" / f"{m['name']}.py").exists()
            if m["name"].endswith("_roofline"):
                assert list((HERE / "metrics" / f"{m['name']}.kernels").glob("*.txt"))


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_file_names_use_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

"""BENCHMARK.json against the benchmark contract's form: names, units,
keys, bounds, and every cell, configuration and metric found as files."""

import json
import re

import pytest

from portbench.core.cells import REPO, ROOT, load_reader, resolve, split_name

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (REPO / p).is_dir()
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert (REPO / BENCH["command"][1]).resolve().is_relative_to(ROOT)


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert (REPO / c["file"]).is_file() and (REPO / c["file"]).resolve().is_relative_to(ROOT)
        data = json.loads((REPO / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[section]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if section == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"
    if section == "end_to_end":
        assert "setup_s" in e2e


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    cell = resolve(workload)
    config, traffic = split_name(workload)
    assert (ROOT / "configs" / f"{config}.json").is_file()
    assert (ROOT / "traffic" / f"{traffic}.json").is_file()
    assert (ROOT / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert (ROOT / "limits" / f"{workload}.json").is_file()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(load_reader(cell, m["name"]))


def test_benchmark_files_are_named_from_name_characters():
    for path in ROOT.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        for part in path.relative_to(ROOT).parts:
            assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", part), path


def test_limits_lie_between_their_readings():
    for workload in CELLS:
        numbers = json.loads((ROOT / "limits" / f"{workload}.json").read_text())["numbers"]
        for name, n in numbers.items():
            assert n["lower"] < n["limit"] < n["upper"], (workload, name)

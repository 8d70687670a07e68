"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from bench_small import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_sizes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert all((ROOT / p).is_dir() for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32
    for word in spec["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word and not word.startswith("/")
    assert spec["command"] == ["python3", "evdbench/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert 1 <= len(spec["configs"]) <= 24 and 1 <= len(spec["workloads"]) <= 24
    assert 1 <= len(spec["end_to_end"]) <= 16 and 1 <= len(spec["per_layer"]) <= 128


def test_entries_have_only_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_texts(spec):
    everything = spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]
    names = [x["name"] for x in everything]
    for group in ("configs", "workloads"):
        group_names = [x["name"] for x in spec[group]]
        assert len(set(group_names)) == len(group_names)
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for n in names + [w["config"] for w in spec["workloads"]] + [w["traffic"] for w in spec["workloads"]]:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([x["why"] for x in spec["configs"] + spec["workloads"]] + [c["source"] for c in spec["configs"]]
                 + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one each
        reported = [m for m in spec["end_to_end"] if cell in m.get("workloads", cells)]
        assert any(m["name"] != "setup_s" for m in reported)
        assert any(cell in m.get("workloads", cells) for m in spec["per_layer"])


def test_cells_configs_and_files_found_by_name(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        used.add(w["config"])
        assert (ROOT / "evdbench" / "traffic" / f"{w['traffic']}.json").is_file()
        traffic = json.loads((ROOT / "evdbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "evdbench" / "entries" / f"{traffic['entry']}.py").is_file()
        assert (ROOT / "evdbench" / "limits" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("evdbench/") and (ROOT / c["file"]).is_file()
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert (ROOT / "evdbench" / "inputs" / f"{config['inputs']}.py").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "evdbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_file_names_use_name_characters():
    for path in (ROOT / "evdbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        assert PATH.match(str(path.relative_to(ROOT))), path

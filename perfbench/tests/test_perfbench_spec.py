"""BENCHMARK.json against the rules its format keeps, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: keys that name a width, which no configuration may cut
WIDTHS = {"hidden_size", "intermediate_size", "d_model", "d_inner",
          "d_state", "headdim", "head_dim", "expand", "d_intermediate",
          "num_experts_per_tok", "kv_lora_rank", "q_lora_rank"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(paths) <= 16 and 1 <= len(cmd) <= 32
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word or (ROOT / word).exists():
            assert any(word == p or word.startswith(p + "/") for p in paths)


def test_run_seconds_fits_the_check_budget():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names(entries):
    return [e["name"] for e in entries]


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = _names(BENCH[group])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"]
        assert spec["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and key not in WIDTHS
        assert (ROOT / "perfbench" / "reference"
                / f"{spec['reference']}.py").is_file()


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = set(_names(BENCH["configs"]))
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        traffic = ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
        driver = json.loads(traffic.read_text())["driver"]
        assert (ROOT / "perfbench" / "drivers" / f"{driver}.py").is_file()
        limits = ROOT / "perfbench" / "limits" / f"{w['name']}.json"
        assert json.loads(limits.read_text())["limits"]
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.add(m["layer"])
        reader = ROOT / "perfbench" / "metrics" / f"{m['name']}.py"
        assert "def read(" in reader.read_text()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_each_cell_reports_what_it_must():
    from perfbench.bench import cell_metrics
    for w in BENCH["workloads"]:
        e2e, per = cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per
        for m in per:
            assert m["moves"] in names, (w["name"], m["name"])
    cells = set(_names(BENCH["workloads"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_rooflines_have_a_step_mfu_beside_them():
    moved = {m["moves"] for m in BENCH["per_layer"]
             if m["name"].split(".")[0].endswith("_roofline")}
    for e2e in moved:
        assert any("mfu" in m["name"] and m["moves"] == e2e
                   for m in BENCH["per_layer"]), e2e


def test_no_code_names_a_cell():
    cells = _names(BENCH["workloads"])
    for path in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for c in cells:
            assert c not in text, (path, c)

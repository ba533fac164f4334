"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and bounds, and that every cell's files are found by name."""
import json
import os
import re

import pytest

from portbench import cells

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_names_and_units(bench):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    metric_names = [m["name"] for m in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_cells_and_metrics_fit_together(bench):
    names = {w["name"] for w in bench["workloads"]}
    assert 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    assert {w["config"] for w in bench["workloads"]} \
        == {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        got = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in got, (w["name"], m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", names)) <= names


def test_roofline_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_every_file_is_found_by_name(bench):
    files = set()
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and "assumed" in cfg
        assert 1 <= cfg["level"] <= 9
        assert cfg["block_bytes"] == 100_000 * cfg["level"]
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        op = cells.op_class(cell.traffic["op"])
        assert op.op == cell.traffic["op"]
        kind = cells.kind(cell.traffic["data"]["kind"])
        assert isinstance(kind.TAG, int) and callable(kind.Maker)
        assert cell.traffic["clients"] >= 1
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]).read)


def test_fits_the_check_budget(bench):
    # 2 + 14 runs a cell at run_seconds + 60, 180 s of compile a cell and
    # 1200 s spare must fit 43200 s with 24 cells
    t = bench["run_seconds"]
    assert (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 <= 43200

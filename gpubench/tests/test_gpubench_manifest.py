"""BENCHMARK.json keeps to the benchmark's contract, and every
configuration, traffic mix and metric it names is found by its name."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "gpubench/run.py"]
    assert man["paths"] == ["gpubench"]
    assert 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_lengths(man):
    entries = man["configs"] + man["workloads"] + man["end_to_end"] + man["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names)), group
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for e in man["configs"] + man["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in man["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_configs_found_and_used(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("gpubench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert set(c["reduced"]) <= set(conf) and conf["reduced"] == c["reduced"]


def test_workloads_found(man, bench):
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell, config, traffic = bench.resolve_cell(man, w["name"], ROOT)
        assert traffic["name"] == w["traffic"] and config["name"] == w["config"]


def test_metrics_found(man, bench):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for w in cells:
        assert any(m["name"] != "setup_s" for m in bench.cell_metrics(man, w, False))
        assert bench.cell_metrics(man, w, True)

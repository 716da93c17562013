"""BENCHMARK.json against its format rules, and every file found by name."""

import json
import os
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark_json()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name, BENCH)
    entry = spec.load_module("entries", cell["traffic"]["entry"])
    assert callable(entry.run)
    assert entry.PEAK_OF in cell["config"]["peak_of"]
    assert cell["config"]["peak_of"][entry.PEAK_OF] in spec.peaks()["flops"]
    assert cell["limits"]["compare"]
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_found_by_name(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert callable(spec.load_module("metrics", metric).read)
    moves = {x["name"]: x for x in BENCH["end_to_end"]}[m["moves"]]
    # a metric's cells each report the end-to-end metric it moves
    for cell in m["workloads"]:
        assert cell in moves.get("workloads", CELLS)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("benchmark/configs/")
    with open(os.path.join(spec.ROOT, cfg["file"])) as fh:
        data = json.load(fh)
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert cfg["reduced"] == []
    assert data["n_filters"] == data["n_rings"] * 8 == 40960
    assert data["n_pixels"] == data["descriptor"]["patch_size"] ** 2


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A cell that pairs a configuration with a traffic mix is found from
    BENCHMARK.json's entries alone (its limits file aside)."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "m50_bf16.compdist",
                               "config": "brown_m50_bf16",
                               "traffic": "compdist", "chips": 1,
                               "why": "x"})
    with pytest.raises(FileNotFoundError, match="limits"):
        spec.cell("m50_bf16.compdist", bench)


def test_metric_reader_shared_by_its_stem():
    mfu = spec.load_module("metrics", "mfu.a_later_cell")
    assert mfu is spec.load_module("metrics", "mfu.pjgrid")
    assert mfu.__file__.endswith("metrics/mfu.py")
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "no_such_metric.pjgrid")

"""The harness finds every cell, configuration and per-layer metric of
BENCHMARK.json by name, and refuses a name it lacks."""
import json
import re

import pytest

import bench_small
from perfbench import harness, traffic

BENCH = traffic.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_opens_with_its_configuration(name):
    cell = harness.open_cell(name, BENCH)
    assert cell.entry["config"] == cell.cell["config"]
    assert cell.conf["file"].startswith("perfbench/configs/")
    assert cell.leaves and cell.paths == sorted(cell.paths)
    assert set(cell.cell["limits"]) == set(harness.check.NUMBERS)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_a_reader_for_each_metric(name):
    cell = harness.open_cell(name, BENCH)
    readers = harness.metric_modules(cell, BENCH)
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]
                            if name in m.get("workloads", [name])}
    for mod in readers.values():
        assert callable(mod.read) and isinstance(mod.WRAPS, list)


def test_an_unknown_cell_is_refused():
    with pytest.raises(traffic.UnknownName):
        harness.open_cell("qwen3-1.7b.no-such-traffic", BENCH)


def test_an_unknown_configuration_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["config"] = "no-such-model"
    name = bench["workloads"][0]["name"]
    with pytest.raises((traffic.UnknownName, ValueError)):
        harness.open_cell(name, bench)


def test_a_metric_without_a_reader_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "no_such_metric", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "model", "moves": "tokens_per_s"})
    cell = harness.open_cell(bench_small.CELLS[0], bench)
    with pytest.raises(traffic.UnknownName):
        harness.metric_modules(cell, bench)


def test_names_and_units_keep_to_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


def test_each_configuration_file_states_every_reduced_key():
    for conf in BENCH["configs"]:
        cfg = json.loads((traffic.ROOT / conf["file"]).read_text())
        assert set(conf["reduced"]) == set(cfg["published"])
        assert cfg["source"] == conf["source"]
        for key in conf["reduced"]:
            assert cfg[key] != cfg["published"][key]

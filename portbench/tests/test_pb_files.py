"""The benchmark's files: BENCHMARK.json against the contract's shape, and
every cell's configuration, traffic mix, cell file and metric reader
loading by name."""

import json
import re

import pytest

from pb_helpers import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["name"] for w in bench["workloads"]} == set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    from portbench.harness import spec
    c = spec.load(name)
    assert c.traffic["target"] in ("vo", "eval")
    assert c.spec["windows_per_s"] > 0
    assert c.spec["limits"], "the cell's limits are set"
    assert set(c.spec["limits"]) <= {"rot_gap", "trans_gap", "imu_gap",
                                     "pgo_gap", "loss_gap", "grad_gap",
                                     "change_gap"}
    for key in ("image_height", "image_width", "batch_size", "preset",
                "drive", "weights", "datatype"):
        assert key in c.config
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_config_files_are_their_own(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg

"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import os
import re

import pytest

from perfbench.harness import manifest as M

MANIFEST = M.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
TEXT = re.compile(r"[^\n\t]{1,200}")


def test_manifest_has_exactly_the_contract_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
             + [w["config"] for w in MANIFEST["workloads"]] + [w["traffic"] for w in MANIFEST["workloads"]]
             + [k for c in MANIFEST["configs"] for k in c["reduced"]])
    for name in names:
        assert M.NAME.fullmatch(name), name
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert M.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in MANIFEST["configs"]] + [c["source"] for c in MANIFEST["configs"]]
                 + [w["why"] for w in MANIFEST["workloads"]] + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert TEXT.fullmatch(text), text


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], MANIFEST["end_to_end"] + MANIFEST["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_metric_entries_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert any(x["name"] == m["moves"] for x in M.end_to_end_of(MANIFEST, cell))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = M.Cell(cell)
    assert os.path.isfile(M.config_path(MANIFEST, c.entry["config"]))
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert hasattr(c.driver, "Driver") and hasattr(c.driver, "stand_in_readings")
    for name, reader in c.readers().items():
        assert callable(reader.read), name
    assert c.limits, f"{cell} has no limits"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2, "setup_s and one rate"
    assert c.per_layer
    assert c.chips in (1, 4)


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_configs_are_used_and_list_their_cuts(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    assert any(w["config"] == config for w in MANIFEST["workloads"])
    assert entry["file"].startswith("perfbench/configs/")
    data = M.load_json(os.path.join(M.ROOT, entry["file"]))
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
